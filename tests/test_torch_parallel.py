"""Port parity: the file mesh and the sharded pipeline
(``parallel/mesh.py``) against the JAX package's on its 8-device CPU mesh,
with the port's 8-entry CPU mesh, on the shapes of ``tests/test_parallel.py``
(spectral 8 x 1 s, RoE 8 x 4 s, band noise 8 x 3 s).

Bounds: frames, counts, clip decisions and the fractions identical (the
fractions are exact integer sums times the same float32 reciprocal, and the
mean over clips sums the entries in XLA's order); ``mean_noise_floor_db``
within 1e-5 relative (``tests/test_torch_suppressor.py``), RoE's
``frain_mean`` within 3 float32 ulps (a mean of peak frequencies, which
JAX's sharded program sums in its own order: 3 ulps apart here, where
``tests/test_torch_roe.py`` holds the unsharded program to 1e-6), and the
band-noise medians within the bounds ``tests/test_torch_band_noise.py``
holds ``N_E`` (1e-5 of its maximum) and ``G_mag`` (1e-4 absolute) to."""

import numpy as np
import pytest
import torch

from audio_processing_tools_tpu.parallel import (
    ShardedRainPipeline as JPipeline,
    make_mesh as jmake_mesh,
)

from audio_processing_tools_tpu_torch.config import DEFAULT_MODE_BANDS
from audio_processing_tools_tpu_torch.parallel import (
    Mesh,
    ShardedRainPipeline,
    ShardedRows,
    local_rows,
    make_mesh,
    shard_batch,
)

FS = 11162
PARAMS = {
    "sample_rate": FS,
    "detector": {"mode_bands": list(DEFAULT_MODE_BANDS)},
    "clip_rain_min_frames": 2,
}
PING = [(520, 1), (900, 0.5), (1600, 0.35), (2450, 0.25)]


def _rain_clip(rng, n):
    """``tests/test_parallel.py:22-29``."""
    x = 0.005 * rng.standard_normal(n)
    k = np.arange(800)
    ping = sum(a * np.sin(2 * np.pi * f * k / FS) for f, a in PING)
    for t0 in rng.integers(FS // 4, n - 2000, 10):
        x[t0 : t0 + 800] += 0.5 * np.exp(-k / 60.0) * ping
    return x.astype(np.float32)


def _spectral_clips(seed, n_rain=4, n_noise=4):
    rng = np.random.default_rng(seed)
    return np.stack([_rain_clip(rng, FS) for _ in range(n_rain)]
                    + [(0.02 * rng.standard_normal(FS)).astype(np.float32)
                       for _ in range(n_noise)])


def _roe_clips(seed):
    """Harmonic pings on four clips, quiet on four (``tests/test_parallel.py:94-105``)."""
    rng = np.random.default_rng(seed)
    n = FS * 4
    k = np.arange(1000)
    ping = sum((1.0 / h) * np.sin(2 * np.pi * 520 * h * k / FS) for h in range(1, 6))
    clips = []
    for b in range(8):
        x = 0.003 * rng.standard_normal(n)
        for t0 in rng.integers(0, n - 1200, 40 if b < 4 else 0):
            x[t0 : t0 + 1000] += 0.6 * np.exp(-k / 80.0) * ping
        clips.append(x)
    return np.stack(clips).astype(np.float32)


def _band_clips(seed, n):
    """Bursty rain-band energy on even clips (``tests/test_parallel.py:130-141``)."""
    rng = np.random.default_rng(seed)
    clips = []
    for b in range(8):
        x = 0.01 * rng.standard_normal(n)
        if b % 2 == 0:
            for t0 in range(FS, n - 3000, FS):
                kk = np.arange(2500)
                x[t0 : t0 + 2500] += 0.5 * np.exp(-kk / 400.0) * np.sin(
                    2 * np.pi * 520 * kk / FS)
        clips.append(x)
    return np.stack(clips).astype(np.float32)


def _ulps(a, b) -> int:
    """The largest distance in float32 units in the last place."""
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max()) if a.size else 0


def _jax_host(out):
    return ({k: np.asarray(v) for k, v in out["per_clip"].items()},
            {k: np.asarray(v) for k, v in out["aggregates"].items()})


def _port_host(out):
    return ({k: local_rows(v) for k, v in out["per_clip"].items()},
            {k: np.asarray(v) for k, v in out["aggregates"].items()})


def test_make_mesh_errors():
    mesh = make_mesh(8, device="cpu")
    assert mesh.size == 8 and mesh.axis_names == ("files",) and mesh.shape == {"files": 8}
    assert (mesh.rank, mesh.world_size) == (0, 1)
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    # the card is the default: past torch.cuda.device_count() (none here) raises
    with pytest.raises(ValueError, match="only"):
        make_mesh(torch.cuda.device_count() + 1)
    with pytest.raises(ValueError):
        make_mesh(0, device="cpu")
    with pytest.raises(ValueError):
        Mesh(["cpu"] * 4, ("files", "seq"))
    with pytest.raises(AttributeError):
        mesh.rank = 1
    grid = Mesh(np.array(["cpu"] * 8, dtype=object).reshape(2, 4), ("files", "seq"))
    assert grid.shape == {"files": 2, "seq": 4} and len(grid.axis_devices("seq")) == 4


def test_shard_batch_local_rows_round_trip():
    rng = np.random.default_rng(3)
    xb = rng.standard_normal((8, 256)).astype(np.float32)
    mesh = make_mesh(4, device="cpu")
    sh = shard_batch(xb, mesh)
    assert isinstance(sh, ShardedRows) and len(sh.blocks) == 4 and sh.shape == (8, 256)
    assert all(b.shape == (2, 256) for b in sh.blocks)
    np.testing.assert_array_equal(local_rows(sh), xb)
    np.testing.assert_array_equal(np.asarray(sh), xb)
    np.testing.assert_array_equal(local_rows(shard_batch(torch.from_numpy(xb), mesh)), xb)
    with pytest.raises(ValueError, match="split"):
        shard_batch(xb[:7], mesh)


@pytest.fixture(scope="module")
def spectral_runs():
    clips = _spectral_clips(1234)
    got = _port_host(ShardedRainPipeline(PARAMS, make_mesh(8, device="cpu")).step(clips))
    ref = _jax_host(JPipeline(PARAMS, jmake_mesh(8)).step(clips))
    return got, ref


def test_spectral_step_matches_jax(spectral_runs):
    (pc, agg), (jpc, jagg) = spectral_runs
    assert pc.keys() == jpc.keys() and agg.keys() == jagg.keys()
    for k in ("frame_class", "rain_frame_count", "clip_is_rain", "clip_rain_fraction"):
        assert pc[k].dtype == jpc[k].dtype, k
        np.testing.assert_array_equal(pc[k], jpc[k], err_msg=k)
    assert pc["clip_is_rain"][:4].all()
    np.testing.assert_allclose(pc["mean_noise_floor_db"], jpc["mean_noise_floor_db"], rtol=1e-5)
    for k in agg:
        assert agg[k].dtype == jagg[k].dtype, k
        np.testing.assert_array_equal(agg[k], jagg[k], err_msg=k)


def test_roe_step_matches_jax():
    clips = _roe_clips(1234)
    params = {"sample_rate": FS, "check_duration": 4}
    pc, agg = _port_host(ShardedRainPipeline(params, make_mesh(8, device="cpu"),
                                             model="roe").step(clips))
    jpc, jagg = _jax_host(JPipeline(params, jmake_mesh(8), model="roe").step(clips))
    assert pc.keys() == jpc.keys() and agg.keys() == jagg.keys()
    for k in ("rain_drop_count_mod", "rain_drop_count", "rain_peaks_count", "clip_is_rain"):
        assert pc[k].dtype == jpc[k].dtype, k
        np.testing.assert_array_equal(pc[k], jpc[k], err_msg=k)
    assert pc["clip_is_rain"].sum() >= 3
    assert pc["frain_mean"].dtype == jpc["frain_mean"].dtype == np.float32
    assert _ulps(pc["frain_mean"], jpc["frain_mean"]) <= 3
    for k in agg:
        np.testing.assert_array_equal(agg[k], jagg[k], err_msg=k)


@pytest.mark.parametrize("n", [FS * 3, 64 * 512], ids=["3s_65_frames", "64_frames_even"])
def test_band_noise_step_matches_jax(n):
    """The even frame count pins the median: the mean of the two middle
    values, as ``jnp.median`` takes it."""
    clips = _band_clips(1234, n)
    params = {"sample_rate": FS}
    pc, agg = _port_host(ShardedRainPipeline(params, make_mesh(8, device="cpu"),
                                             model="band_noise").step(clips))
    jpc, jagg = _jax_host(JPipeline(params, jmake_mesh(8), model="band_noise").step(clips))
    assert pc.keys() == jpc.keys() and agg.keys() == jagg.keys()
    for k in ("fft_rain_fraction", "clip_is_rain"):
        assert pc[k].dtype == jpc[k].dtype, k
        np.testing.assert_array_equal(pc[k], jpc[k], err_msg=k)
    assert (pc["fft_rain_fraction"][::2] > 0).all()
    ne = np.abs(pc["median_N_E"] - jpc["median_N_E"]).max()
    assert ne <= 1e-5 * np.abs(jpc["median_N_E"]).max()
    assert np.abs(pc["median_G"] - jpc["median_G"]).max() <= 1e-4
    for k in ("total_rain_clips", "total_clips"):
        np.testing.assert_array_equal(agg[k], jagg[k], err_msg=k)
    np.testing.assert_allclose(agg["mean_noise_energy"], jagg["mean_noise_energy"], rtol=1e-5)


def test_median_takes_the_mean_of_the_middle_pair():
    from audio_processing_tools_tpu_torch.parallel.mesh import _median

    x = torch.tensor([[4.0, 1.0, 3.0, 2.0], [1.0, 2.0, 3.0, 10.0]])
    np.testing.assert_array_equal(_median(x).numpy(), [2.5, 2.5])
    np.testing.assert_array_equal(_median(x[:, :3]).numpy(), [3.0, 2.0])


def test_ragged_batch_pads_like_jax():
    """5 clips on an 8-entry mesh: ``step`` counts the 3 silence rows in
    ``total_clips`` and the mean fraction; ``run_corpus`` recounts the real
    rows.  Both as in JAX."""
    clips = _spectral_clips(7, n_rain=5, n_noise=0)
    pipe = ShardedRainPipeline(PARAMS, make_mesh(8, device="cpu"))
    jpipe = JPipeline(PARAMS, jmake_mesh(8))
    pc, agg = _port_host(pipe.step(clips))
    jpc, jagg = _jax_host(jpipe.step(clips))
    assert agg["total_clips"] == jagg["total_clips"] == 8
    assert pc["frame_class"].shape[0] == 8
    np.testing.assert_array_equal(agg["mean_rain_fraction"], jagg["mean_rain_fraction"])
    got, ref = pipe.run_corpus(clips, batch=8), jpipe.run_corpus(clips, batch=8)
    assert got["aggregates"] == ref["aggregates"] and got["aggregates"]["total_clips"] == 5
    assert got["per_clip"]["frame_class"].shape[0] == 5
    np.testing.assert_array_equal(got["per_clip"]["rain_frame_count"],
                                  ref["per_clip"]["rain_frame_count"])


def test_unknown_model_raises():
    with pytest.raises(ValueError, match="unknown model"):
        ShardedRainPipeline({"sample_rate": FS}, make_mesh(2, device="cpu"), model="bogus")
