"""Port parity: time-axis sharding (``parallel/sequence.py``) against the
JAX package's ``shard_map`` functions on its 8-device CPU mesh, and against
the port's own unsharded causal spectrogram.  The port's meshes are 8 CPU
entries and a 2 x 4 (``files``, ``seq``) grid; K1 runs its plain version on
the CPU.

Bounds (``tests/test_sequence_parallel.py``): power within 1e-5 of its
maximum, flux within 1e-4 of its maximum; against the port's unsharded
spectrogram the power is identical (each frame sees the same samples)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from audio_processing_tools_tpu.parallel import make_mesh as jmake_mesh
from audio_processing_tools_tpu.parallel import sequence as jseq

from audio_processing_tools_tpu_torch.ops.stft import stft_power
from audio_processing_tools_tpu_torch.parallel import Mesh, make_mesh
from audio_processing_tools_tpu_torch.parallel import sequence as tseq

FS = 11162
HOP, NFFT = 128, 256


def _signal(rng, n):
    """``tests/test_sequence_parallel.py:18-23``."""
    x = 0.01 * rng.standard_normal(n)
    for t0 in rng.integers(2000, n - 2000, 20):
        k = np.arange(800)
        x[t0 : t0 + 800] += 0.5 * np.exp(-k / 60.0) * np.sin(2 * np.pi * 520 * k / FS)
    return x.astype(np.float32)


def _close(got, ref, rel):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= rel * np.abs(ref).max()


def _grids():
    jgrid = JMesh(np.array(jax.devices()[:8]).reshape(2, 4), ("files", "seq"))
    tgrid = Mesh(np.array(["cpu"] * 8, dtype=object).reshape(2, 4), ("files", "seq"))
    return jgrid, tgrid


def test_stft_power_matches_jax_and_unsharded():
    x = _signal(np.random.default_rng(1), 8 * HOP * 64)  # 65,536 samples
    got = tseq.sequence_sharded_stft_power(x, make_mesh(8, device="cpu"))
    ref = np.asarray(jseq.sequence_sharded_stft_power(jnp.asarray(x), jmake_mesh(8)))
    _close(got, ref, 1e-5)
    assert got.shape == (129, 8 * 64 - 1)
    assert torch.equal(got, stft_power(torch.from_numpy(x), center=False))


def test_band_flux_matches_jax():
    x = _signal(np.random.default_rng(2), 8 * HOP * 64)
    got = tseq.sequence_sharded_band_flux(x, make_mesh(8, device="cpu"), fs=FS)
    ref = jseq.sequence_sharded_band_flux(jnp.asarray(x), jmake_mesh(8), fs=FS)
    assert got.keys() == ref.keys()
    _close(got["band_power"], ref["band_power"], 1e-5)
    _close(got["mode_flux"], ref["mode_flux"], 1e-4)
    # against the port's unsharded flux: frames 0 and 1 are warm-up zeros
    one = tseq.sequence_sharded_band_flux(x, make_mesh(1, device="cpu"), fs=FS)
    assert torch.equal(got["band_power"], one["band_power"])
    _close(got["mode_flux"], one["mode_flux"], 1e-4)
    assert not got["mode_flux"][:, :2].any() and got["mode_flux"].max() > 0


def test_batch_2d_mesh_matches_jax():
    rng = np.random.default_rng(3)
    n = 4 * HOP * 32
    xb = np.stack([_signal(rng, n), _signal(rng, n)])
    jgrid, tgrid = _grids()
    got = tseq.batch_sequence_sharded_stft_power(xb, tgrid)
    ref = np.asarray(jseq.batch_sequence_sharded_stft_power(jnp.asarray(xb), jgrid))
    _close(got, ref, 1e-5)
    assert torch.equal(got, stft_power(torch.from_numpy(xb), center=False))


@pytest.mark.parametrize("draw", range(4))
def test_geometry_fuzz_matches_jax(draw):
    """JAX's seeded fuzz over (n_fft, hop, shard count, length)
    (``tests/test_sequence_parallel.py:101-123``)."""
    prng = np.random.default_rng(600 + draw)
    n_fft = int(prng.choice([128, 256, 512]))
    hop = int(prng.choice([n_fft // 4, n_fft // 2]))
    n_dev = int(prng.choice([2, 4, 8]))
    n = n_dev * hop * int(prng.integers(80, 160))
    x = _signal(prng, n)
    got = tseq.sequence_sharded_stft_power(x, make_mesh(n_dev, device="cpu"),
                                           n_fft=n_fft, hop=hop)
    ref = np.asarray(jseq.sequence_sharded_stft_power(jnp.asarray(x), jmake_mesh(n_dev),
                                                      n_fft=n_fft, hop=hop))
    _close(got, ref, 1e-5)
    assert torch.equal(got, stft_power(torch.from_numpy(x), n_fft=n_fft, hop=hop,
                                       center=False))


def test_validation_errors_match_jax():
    jgrid, tgrid = _grids()
    cases = [
        (lambda m: tseq.sequence_sharded_stft_power(np.zeros(1000, np.float32), m),
         lambda m: jseq.sequence_sharded_stft_power(jnp.zeros(1000, jnp.float32), m), 8),
        (lambda m: tseq.sequence_sharded_band_flux(np.zeros(1000, np.float32), m),
         lambda m: jseq.sequence_sharded_band_flux(jnp.zeros(1000, jnp.float32), m), 8),
    ]
    for port, ref, n_dev in cases:
        with pytest.raises(ValueError) as got:
            port(make_mesh(n_dev, device="cpu"))
        with pytest.raises(ValueError) as want:
            ref(jmake_mesh(n_dev))
        assert str(got.value) == str(want.value)
    for shape in ((3, 4 * HOP * 8), (2, 4 * HOP * 8 + 1)):
        with pytest.raises(ValueError) as got:
            tseq.batch_sequence_sharded_stft_power(np.zeros(shape, np.float32), tgrid)
        with pytest.raises(ValueError) as want:
            jseq.batch_sequence_sharded_stft_power(jnp.zeros(shape), jgrid)
        assert str(got.value) == str(want.value)
