"""Port parity: the band-noise estimator (kernels K1, K4 and K6 run their
plain versions on the CPU) against the JAX package's
``models/band_noise.py`` and ``models/band_noise_streaming.py``, and the
port's own bit contract: whole clip, chunked, frame by frame and batched
give the same bits.

Tolerances against JAX: integer and boolean fields identical; float fields
within 1e-5 of their JAX maximum (the IIR bound of ``tools/tpu_checks.py``:
the port sums each dot product in its own fixed order, and its FFT library
is not JAX's); ``noise_effective_q`` within 1e-5 absolute; ``G_mag`` within
1e-4 absolute (near the 0.1 gain floor the square root doubles the
cancellation in ``Eb - N_E``; JAX's own bound against its float64 oracle is
5e-3).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as ss
import torch

from audio_processing_tools_tpu.models import band_noise as jb
from audio_processing_tools_tpu.models import band_noise_streaming as jbs
from audio_processing_tools_tpu.ops import filters as jf
from audio_processing_tools_tpu.ops import stats as jstats

from audio_processing_tools_tpu_torch import _kernels
from audio_processing_tools_tpu_torch.models import band_noise as tb
from audio_processing_tools_tpu_torch.models import band_noise_streaming as tbs
from audio_processing_tools_tpu_torch.ops import filters as tf
from audio_processing_tools_tpu_torch.ops import stats as tstats

FS = 11162
N = 512


def _signal(seed, seconds=6.0):
    """Noise with loud 520 Hz bursts every second (``tests/test_band_noise.py:225-232``)."""
    rng = np.random.default_rng(seed)
    n = int(FS * seconds)
    x = 0.01 * rng.standard_normal(n)
    k = np.arange(2500)
    for t0 in range(FS, n - 3000, FS):
        x[t0 : t0 + 2500] += 0.5 * np.exp(-k / 400.0) * np.sin(2 * np.pi * 520 * k / FS)
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def clips():
    return np.stack([_signal(s) for s in (1, 2)])


# the configurations of tests/test_band_noise.py:235-239, and the two
# detector triggers
CONFIGS = {
    "default": {},
    "smooth_N_E": {"smooth_N_E": True},
    "replenish_ttl": {"noise_replenish_from_all_subframes": True, "noise_buffer_ttl_frames": 20},
    "D_trigger": {"det": {"use_D_trigger": True}},
    "dE_trigger": {"det": {"use_dE_over_Ehpf": True}},
}


def _configs(name):
    kw = dict(CONFIGS[name])
    det = kw.pop("det", {})
    return (jb.BandNoiseEstimatorConfig(det=jb.NoiseFrameDetectorConfig(**det), **kw),
            tb.BandNoiseEstimatorConfig(det=tb.NoiseFrameDetectorConfig(**det), **kw))


def _host(out):
    return {k: np.asarray(v) for k, v in out.items()}


def _assert_matches_jax(got, ref):
    assert got.keys() == ref.keys()
    for k in tb.FRAME_OUT_FIELDS:
        a, b = np.asarray(got[k]), np.asarray(ref[k])
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if b.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=k)
        elif k == "G_mag":
            assert np.abs(a - b).max() <= 1e-4, k
        elif k == "noise_effective_q":
            assert np.abs(a - b).max() <= 1e-5, k
        else:
            assert np.abs(a - b).max() <= 1e-5 * max(np.abs(b).max(), 1e-30), k


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# K4's plain version
# ---------------------------------------------------------------------------


def _k4_sos(which):
    hpf, bpf = tb._design_filters(tb.BandNoiseEstimatorConfig())
    return hpf if which == "highpass" else bpf


@pytest.mark.parametrize("T", [128 * 40, 128 * 40 - 77, 129], ids=["blocks", "partial", "129"])
@pytest.mark.parametrize("which", ["highpass", "bandpass"])
def test_cascade_scan_matches_jax_and_scipy(which, T):
    """K4's plain version from a nonzero state: y and zf within 1e-5 of the
    JAX ``boundary="scan"`` cascade and ``sosfilt_matmul_zf``, and of scipy
    in float64."""
    sos = _k4_sos(which)
    rng = np.random.default_rng(3)
    x = (0.1 * rng.standard_normal((3, T))).astype(np.float32)
    zi = (0.01 * rng.standard_normal((3, sos.shape[0], 2))).astype(np.float32)
    _kernels.reset_launches()
    y, zf = tf.cascade_sosfilt(sos, torch.from_numpy(x), torch.from_numpy(zi))
    assert _kernels.LAUNCHES["cascade_sosfilt"] == 0  # the CPU runs no kernel
    yj, zfj = jf._sosfilt_cascade_matmul(sos, jnp.asarray(x), jnp.asarray(zi), boundary="scan",
                                         return_zf=True)
    yj2, zfj2 = jf.sosfilt_matmul_zf(sos, jnp.asarray(x), jnp.asarray(zi))
    ysp, zsp = ss.sosfilt(sos, x.astype(np.float64), axis=-1,
                          zi=zi.astype(np.float64).transpose(1, 0, 2))
    for got, ref in ((y, yj), (zf, zfj), (y, yj2), (zf, zfj2), (y, ysp),
                     (zf, zsp.transpose(1, 0, 2))):
        ref = np.asarray(ref, np.float64)
        assert got.shape == ref.shape
        assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


def test_cascade_scan_chunks_give_one_calls_bits():
    sos = _k4_sos("bandpass")
    x = torch.from_numpy((0.1 * np.random.default_rng(4).standard_normal((2, 128 * 30 + 50)))
                         .astype(np.float32))
    zi = torch.zeros(sos.shape[0], 2)
    y1, z1 = tf.cascade_sosfilt(sos, x, zi)
    ys, z = [], zi
    for a in range(0, x.shape[1], 128 * 7):
        y, z = tf.cascade_sosfilt(sos, x[:, a : a + 128 * 7], z)
        ys.append(y)
    assert torch.equal(torch.cat(ys, dim=-1), y1) and torch.equal(z, z1)


def test_cascade_scan_kernel_wrapper_raises_on_a_cpu_tensor():
    """K4's wrapper launches or raises: no fallback to the plain version."""
    sos = _k4_sos("highpass")
    table = torch.from_numpy(tf._k4_flat_tables(sos, 128).astype(np.float32))
    with pytest.raises(ValueError):
        tf._cascade_sosfilt_cuda(table, torch.zeros(2, 256), torch.zeros(2, 4), 2)


def test_k4_table_layout():
    """K4 reads L as its first column: L is Toeplitz in float32 too."""
    sos = _k4_sos("bandpass")
    L, Zmat, Kblk, Ablk, Ap = tf.cascade_scan_tables(sos, 128, 51)
    L32 = L.astype(np.float32)
    i, u = np.tril_indices(128)
    np.testing.assert_array_equal(L32[i, u], L32[i - u, 0])
    flat = tf._k4_flat_tables(sos, 51)
    n = 2 * sos.shape[0]
    assert flat.size == 128 + 2 * 128 * n + 2 * n * n
    np.testing.assert_array_equal(flat[128 : 128 + 128 * n], Kblk.ravel())
    np.testing.assert_allclose(Ap, np.linalg.matrix_power(tf._cascade_state_space(sos)[0], 51))


# ---------------------------------------------------------------------------
# The masked quantile
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["random", "ties", "none_valid", "all_valid"])
def test_masked_quantile_rankselect_matches_jax(case):
    rng = np.random.default_rng({"random": 0, "ties": 1, "none_valid": 2, "all_valid": 3}[case])
    for _ in range(20):
        x = rng.random(30).astype(np.float32)
        if case == "ties":
            x = rng.choice(np.float32([0.25, 0.5, 1.0]), 30)
        valid = rng.random(30) < 0.6
        if case == "none_valid":
            valid[:] = False
        if case == "all_valid":
            valid[:] = True
        q = np.float32(rng.random())
        ref = np.asarray(jstats.masked_quantile_rankselect(jnp.asarray(x), jnp.asarray(valid), q))
        ref_sort = np.asarray(jstats.masked_quantile(jnp.asarray(x), jnp.asarray(valid), q))
        got = tstats.masked_quantile_rankselect(torch.from_numpy(x), torch.from_numpy(valid),
                                                float(q))
        assert got.numpy().tobytes() == ref.tobytes() == ref_sort.tobytes()
    # batched, with a per-row q
    xb = rng.random((4, 30)).astype(np.float32)
    vb = rng.random((4, 30)) < 0.5
    qb = rng.random(4).astype(np.float32)
    got = tstats.masked_quantile_rankselect(torch.from_numpy(xb), torch.from_numpy(vb),
                                            torch.from_numpy(qb))
    for i in range(4):
        ref = jstats.masked_quantile_rankselect(jnp.asarray(xb[i]), jnp.asarray(vb[i]), qb[i])
        assert got[i].numpy().tobytes() == np.asarray(ref).tobytes()


class _SortedRing:
    """NumPy model of K6's ring buffer (``csrc/band_noise.cu``, ``Ring``):
    the slot-ordered ring and, beside it, its valid values in ascending order
    at positions 0..n-1 (float32's maximum past them), each with its slot.
    A frame's pushes go in as one merge, as the kernel's ``Ring::push`` does
    them: the overwritten slots' entries go out, a surviving entry moves to
    the survivors before it plus the new values below it, a new value to the
    survivors not above it plus the new values before it; an expiry
    compacts the survivors."""

    def __init__(self, W):
        self.W, self.P = W, 32 * -(-W // 32)
        self.bv = np.zeros(W, np.float32)
        self.bi = np.full(W, -1)
        self.valid = np.zeros(W, bool)
        self.sk = np.full(self.P, np.finfo(np.float32).max, np.float32)
        self.ss = np.full(self.P, -1)
        self.wr = 0

    def push_batch(self, values, frame):
        m, W, wr0 = len(values), self.W, self.wr
        pos, n = np.arange(self.P), int(self.valid.sum())
        slots = (wr0 + np.arange(m)) % W
        surv = (pos < n) & ((self.ss - wr0) % W >= m)
        key, slot = np.full(self.P, np.nan, np.float32), np.full(self.P, -2)
        u = np.float32(values)
        for l in np.flatnonzero(surv):
            d = int(surv[:l].sum()) + int((u < self.sk[l]).sum())
            key[d], slot[d] = self.sk[l], self.ss[l]
        for s in range(m):
            d = int((surv & (self.sk <= u[s])).sum())
            d += int(((u < u[s]) | ((u == u[s]) & (np.arange(m) < s))).sum())
            key[d], slot[d] = u[s], slots[s]
        n_new = int(surv.sum()) + m
        key[n_new:], slot[n_new:] = np.finfo(np.float32).max, -1
        assert not np.isnan(key).any() and (slot != -2).all()  # a permutation
        self.sk, self.ss = key, slot
        self.bv[slots], self.bi[slots], self.valid[slots] = u, frame, True
        self.wr = (wr0 + m) % W

    def expire(self, frame, ttl):
        stale = self.valid & (frame - self.bi > ttl)
        n = int(self.valid.sum())
        keep = (np.arange(self.P) < n) & ~stale[np.clip(self.ss, 0, self.W - 1)]
        kept = int(keep.sum())
        self.sk[:kept], self.ss[:kept] = self.sk[keep], self.ss[keep]
        self.sk[kept:], self.ss[kept:] = np.finfo(np.float32).max, -1
        self.valid &= ~stale
        self.bv[stale], self.bi[stale] = 0.0, -1

    def quantile(self, q):
        """The order statistics at the sorted view's positions lo and hi."""
        count = int(self.valid.sum())
        h = np.float32(q) * np.float32(max(count - 1, 0))
        lo, hi = int(np.floor(h)), int(np.ceil(h))
        frac = h - np.float32(lo)
        v_lo, v_hi = self.sk[lo], self.sk[hi]
        return v_lo + frac * (v_hi - v_lo) if count > 0 else np.float32(0.0)


@pytest.mark.parametrize("W", [8, 30, 64])
def test_k6_sorted_ring_reads_the_rank_counts_quantile(W):
    """K6 reads the buffer's quantile from its sorted view: over frames of 0
    to 8 pushes (values with many ties; a single push is a replenish) and TTL
    expiry, the view holds the valid values in order, each with its slot, and
    the value it reads has the bits of masked_quantile_rankselect, the
    port's and JAX's."""
    rng = np.random.default_rng(W)
    ring = _SortedRing(W)
    levels = rng.random(6).astype(np.float32) + np.float32(1e-3)
    ttl = int(rng.integers(3, 12))
    for frame in range(1, 121):
        ring.expire(frame, ttl)
        pushes = [levels[rng.integers(6)] if rng.random() < 0.6 else rng.random()
                  for _ in range(int(rng.choice([0, 0, 1, 4, 8])))]
        if pushes:
            ring.push_batch(pushes, frame)
        n = int(ring.valid.sum())
        assert np.array_equal(ring.sk[:n], np.sort(ring.bv[ring.valid]))
        assert np.array_equal(np.sort(ring.ss[:n]), np.flatnonzero(ring.valid))
        assert np.array_equal(ring.bv[ring.ss[:n]], ring.sk[:n])
        q = np.float32(rng.random())
        got = np.float32(ring.quantile(q))
        ref_t = tstats.masked_quantile_rankselect(torch.from_numpy(ring.bv),
                                                  torch.from_numpy(ring.valid), float(q))
        ref_j = np.asarray(jstats.masked_quantile_rankselect(jnp.asarray(ring.bv),
                                                             jnp.asarray(ring.valid), q))
        assert got.tobytes() == ref_t.numpy().tobytes() == ref_j.tobytes()


# ---------------------------------------------------------------------------
# The estimator against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(CONFIGS))
def test_band_noise_process_matches_jax(clips, name):
    jcfg, tcfg = _configs(name)
    ref = _host(jax.vmap(lambda v: jb.band_noise_process(v, jcfg))(jnp.asarray(clips)))
    _kernels.reset_launches()
    got = _host(tb.band_noise_process(torch.from_numpy(clips), tcfg, device="cpu"))
    assert all(v == 0 for v in _kernels.LAUNCHES.values())
    _assert_matches_jax(got, ref)
    assert got["fft_rain_frame"].sum() > 0 and got["rain_submask"].mean() > 0.01
    # a 1-D clip has no stream axis
    one = _host(tb.band_noise_process(torch.from_numpy(clips[1]), tcfg, device="cpu"))
    assert all(np.array_equal(one[k], got[k][1]) for k in got)


def test_band_noise_process_runs_a_numpy_clip_on_the_requested_device(clips):
    """A NumPy clip (what the JAX function takes) runs on ``device``: the
    card by default, the CPU only when asked for."""
    cfg = tb.BandNoiseEstimatorConfig()
    x = clips[0, : 20 * N]
    out = tb.band_noise_process(x, cfg, device="cpu")
    assert all(v.device.type == "cpu" for v in out.values())
    _equal(out, tb.band_noise_process(torch.from_numpy(x), cfg, device="cpu"))
    if torch.cuda.is_available():
        assert tb.band_noise_process(x, cfg)["N_E"].device.type == "cuda"
    else:  # no silent fall back to the CPU
        with pytest.raises((AssertionError, RuntimeError)):
            tb.band_noise_process(x, cfg)


def test_chunked_per_frame_and_batched_bit_for_bit(clips):
    """512 x 17 chunks, single frames through ``BandNoiseEstimator`` and each
    stream alone give the batched whole-clip call's bits."""
    cfg = tb.BandNoiseEstimatorConfig(noise_replenish_from_all_subframes=True,
                                      noise_buffer_ttl_frames=20)
    x = torch.from_numpy(clips[:, : clips.shape[1] // N * N])
    full = tb.band_noise_process(x, cfg, device="cpu")
    state, parts = tb.band_noise_init_state(cfg, 2, "cpu"), []
    for i in range(0, x.shape[1], N * 17):
        out, state = tb.band_noise_process_chunk(x[:, i : i + N * 17], cfg, state)
        parts.append(out)
    _equal({k: torch.cat([p[k] for p in parts], dim=1) for k in parts[0]}, full)
    for i in range(2):
        _equal(tb.band_noise_process(x[i : i + 1], cfg, device="cpu"),
               {k: v[i : i + 1] for k, v in full.items()})
    est = tbs.BandNoiseEstimator(cfg, device="cpu")
    frames = list(est.process_stream(x[1, : 40 * N].numpy()))
    assert len(frames) == 40 and all(isinstance(f, tbs.BandNoiseFrameOut) for f in frames)
    for k in ("N_E", "G_mag", "M_clean", "E_band", "noise_effective_q"):
        np.testing.assert_array_equal(np.float32([getattr(f, k) for f in frames]),
                                      full[k][1, :40].numpy(), err_msg=k)
    np.testing.assert_array_equal(np.stack([f.rain_submask for f in frames]),
                                  full["rain_submask"][1, :40].numpy())
    assert [f.noise_buffer_valid_count for f in frames] == \
        full["noise_buffer_valid_count"][1, :40].tolist()
    with pytest.raises(ValueError, match="frame_len"):
        est.process_frame(np.zeros(10, np.float32))


def test_reset_mid_stream_and_energy_stats(clips):
    cfg = tb.BandNoiseEstimatorConfig()
    x = clips[0, : 60 * N]
    est = tbs.BandNoiseEstimator(cfg, device="cpu")
    assert est.read_and_reset_energy_stats().total_frame_count == 0
    for t in range(30):
        est.process_frame(x[t * N : (t + 1) * N])
    s1 = est.read_and_reset_energy_stats()
    est.reset_noise_estimator()
    out = est.process_frame(x[30 * N : 31 * N])
    assert out.N_E == 0.0  # the warm-up starts again
    assert out.noise_buffer_valid_count <= tb.n_subframes(cfg)
    # the reset keeps the filter state and the frame index (the TTL's timebase)
    ref = tbs.BandNoiseEstimator(cfg, device="cpu")
    for t in range(31):
        ref_out = ref.process_frame(x[t * N : (t + 1) * N])
    assert torch.equal(est.state["zi_h"], ref.state["zi_h"])
    assert torch.equal(est.state["zi_b"], ref.state["zi_b"]) and out.E_band == ref_out.E_band
    assert int(est.state["scan"]["frame_idx"]) == 31
    for t in range(31, 60):
        est.process_frame(x[t * N : (t + 1) * N])
    s2 = est.read_and_reset_energy_stats()
    assert (s1.total_frame_count, s2.total_frame_count) == (30, 30)
    assert "noise_energy_mean" in s2.as_dict()
    # the same reset through the JAX package
    js = jb.band_noise_init_state(jb.BandNoiseEstimatorConfig())
    _, js = jb.band_noise_process_chunk(jnp.asarray(x[: 30 * N]), jb.BandNoiseEstimatorConfig(), js)
    js = jb.band_noise_reset_noise_estimator(jb.BandNoiseEstimatorConfig(), js)
    ps = tb.band_noise_init_state(cfg, 1, "cpu")
    _, ps = tb.band_noise_process_chunk(torch.from_numpy(x[: 30 * N])[None], cfg, ps)
    ps = tb.band_noise_reset_noise_estimator(cfg, ps)
    back = tb.state_to_jax(ps, stream=0)
    for k in tb._RESET_KEYS:
        np.testing.assert_array_equal(back["scan"][k], np.asarray(js["scan"][k]), err_msg=k)


def test_state_round_trip_and_a_jax_stream_continued(clips):
    """A stream begun in JAX goes on in the port from the JAX state (and
    back); the state maps leaf for leaf."""
    jcfg, tcfg = _configs("default")
    x = clips[0, : 80 * N]
    ref = _host(jb.band_noise_process(jnp.asarray(x), jcfg))
    jo, js = jb.band_noise_process_chunk(jnp.asarray(x[: 40 * N]), jcfg,
                                         jb.band_noise_init_state(jcfg))
    js = jax.tree_util.tree_map(np.asarray, js)
    ps = tb.state_from_jax(js, device="cpu")
    assert ps["seeded"].shape == (1,) and ps["scan"]["buf"].shape == (1, jcfg.W)
    back = tb.state_to_jax(ps, stream=0)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(js)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(js)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    po, ps = tb.band_noise_process_chunk(torch.from_numpy(x[40 * N :])[None], tcfg, ps)
    got = {k: np.concatenate([np.asarray(jo[k]), po[k][0].numpy()]) for k in ref}
    _assert_matches_jax(got, ref)
    # and the port's state goes on in JAX
    ps2 = tb.band_noise_init_state(tcfg, 1, "cpu")
    _, ps2 = tb.band_noise_process_chunk(torch.from_numpy(x[: 40 * N])[None], tcfg, ps2)
    jo2, _ = jb.band_noise_process_chunk(jnp.asarray(x[40 * N :]), jcfg,
                                         tb.state_to_jax(ps2, stream=0))
    np.testing.assert_array_equal(np.asarray(jo2["fft_rain_frame"]), ref["fft_rain_frame"][40:])
    # a batch: stack and split
    both = tb.stack_states([tb.band_noise_init_state(tcfg, 1, "cpu"), ps2])
    assert both["scan"]["buf"].shape == (2, tcfg.W)
    parts = tb.split_state(both)
    assert torch.equal(parts[1]["scan"]["buf"], ps2["scan"]["buf"])
    assert tb.state_to_jax(both)["zi_b"].shape == (2, 4, 2)


def test_noise_frame_detector_twin_matches_the_scan(clips):
    cfg = tb.BandNoiseEstimatorConfig()
    x = clips[1, : 60 * N]
    ref = tb.band_noise_process(torch.from_numpy(x), cfg, device="cpu")
    T = x.size // N
    hpf, bpf = tb._design_filters(cfg)
    xt = torch.from_numpy(x)[None]
    x_h, x_bp, _, _ = tb._filters(cfg, xt, tb._seed(hpf, xt[:, 0]), tb._seed(bpf, xt[:, 0]))
    subE, subEhpf, *_ = tb._per_frame_inputs(x_h, x_bp, cfg, T)
    frames_h = x_h[0].numpy().reshape(T, N)
    P_fft = np.abs(np.fft.rfft(frames_h, n=N, axis=-1)) ** 2
    det = tbs.NoiseFrameDetector(cfg.det, subframes_per_frame=tb.n_subframes(cfg))
    jdet = jbs.NoiseFrameDetector(jb.NoiseFrameDetectorConfig(), subframes_per_frame=4)
    got_fft, got_mask = [], []
    for t in range(T):
        kw = dict(subEhpf=subEhpf[0, t].numpy(), fft_power=P_fft[t])
        fr, mask = det.process_frame(frames_h[t], subE[0, t].numpy(), **kw)
        assert (fr, mask.tolist()) == (lambda r: (r[0], r[1].tolist()))(
            jdet.process_frame(frames_h[t], subE[0, t].numpy(), **kw))
        got_fft.append(fr)
        got_mask.append(mask)
    np.testing.assert_array_equal(got_fft, ref["fft_rain_frame"].numpy())
    np.testing.assert_array_equal(np.stack(got_mask), ref["rain_submask"].numpy())
    assert tbs.NoiseFrameDetector(cfg.det, subframes_per_frame=4).fft_rain(frames_h[0]) is False


# ---------------------------------------------------------------------------
# The processor and the config
# ---------------------------------------------------------------------------


def test_processor_metrics_match_jax(clips):
    x = clips[:, : 3 * FS]
    params = {"sample_rate": FS}
    proc = tb.BandNoiseEstimatorProcessor(device="cpu")
    metrics, state = proc.run(x[0], params)
    rm, rs = jb.BandNoiseEstimatorProcessor().run(x[0], params)
    assert metrics.keys() == rm.keys() and state.keys() == rs.keys()
    assert metrics["n_frames"] == x.shape[1] // N and state["processor"] == "band_noise"
    for k, v in rm.items():
        if k == "latency_s":
            continue
        if isinstance(v, float) and "count" not in k:
            assert abs(metrics[k] - v) <= 1e-4 * max(abs(v), 1e-6) + 1e-6, k
        else:
            assert metrics[k] == v, k
    pairs = proc.run_batch(x, params)
    assert len(pairs) == 2 and pairs[0][0]["n_frames"] == metrics["n_frames"]
    assert pairs[0][0]["energy_stats__total_frame_count"] == metrics["n_frames"]
    np.testing.assert_array_equal(pairs[0][1]["N_E"], state["N_E"])
    with pytest.raises(ValueError, match="hop"):
        proc.run(x[0], {"sample_rate": FS, "hop": 256})
    with pytest.raises(ValueError, match="hop"):
        proc.run_batch(x, {"sample_rate": FS, "hop": 256})
    # less than one frame: JAX raises an IndexError, the port a ValueError
    with pytest.raises(ValueError, match="one frame"):
        proc.run(x[0, :300], params)


def test_config_dotted_overrides_and_validation():
    params = {"sample_rate": FS, "W": 20, "det.M_db": 9.0, "det.k_subframes": 3,
              "det": {"N_db": 4.0}, "band_hz": [420, 690],
              "det.rain_bands_hz": [[450, 650], [800, 1050]]}
    cfg = tb.build_band_noise_config(params)
    ref = jb.build_band_noise_config(params)
    assert (cfg.W, cfg.det.M_db, cfg.det.N_db, cfg.det.k_subframes) == (20, 9.0, 4.0, 3)
    assert cfg.band_hz == (420, 690) and cfg.det.rain_bands_hz == ((450, 650), (800, 1050))
    from dataclasses import asdict
    assert asdict(cfg) == asdict(ref)
    for bad in ({"subframe_len": 100}, {"q": 1.5}, {"W": 5, "W_min": 10}, {"band_hz": (700, 400)},
                {"noise_replenish_q": 0.0}, {"ema_alpha": 0.0}, {"noise_buffer_ttl_frames": -1},
                {"det": tb.NoiseFrameDetectorConfig(n_fft=256)}):
        with pytest.raises(ValueError):
            tb.BandNoiseEstimatorConfig(**bad).validate()


def test_band_scan_kernel_wrapper_raises_on_a_cpu_tensor():
    """K6's wrapper launches or raises: no fallback to the plain loop."""
    cfg = tb.BandNoiseEstimatorConfig()
    z3, z2 = torch.zeros(1, 2, 4), torch.zeros(1, 2)
    with pytest.raises(ValueError):
        tb._band_scan_cuda(cfg, tb._scan_carry_init(cfg, 1, "cpu"), (z3, z3, z2, z2, z2, z2))


def _c_struct(name):
    src = (Path(tb.__file__).resolve().parent.parent / "csrc" / "band_noise.cu").read_text()
    body = re.search(rf"struct {name} \{{(.*?)\n\}};", src, re.S).group(1)
    fields = []
    for line in re.sub(r"//[^\n]*", "", body).split(";"):
        line = line.strip()
        if line:
            decl = re.sub(r"^(const\s+)?\w+\s*", "", line)
            fields += [re.sub(r"[*\s]", "", d) for d in decl.split(",")]
    return fields


@pytest.mark.parametrize("struct", ["BandConsts", "BandIO"])
def test_k6_arguments_mirror_the_source(struct):
    """The ctypes structures K6 is launched with name the C structures'
    fields in their order, and the carry and output layouts are the
    source's (the kernel runs only on the card)."""
    py = {"BandConsts": tb._BandConsts, "BandIO": tb._BandIO}[struct]
    assert [f[0] for f in py._fields_] == _c_struct(struct)
    src = (Path(tb.__file__).resolve().parent.parent / "csrc" / "band_noise.cu").read_text()
    assert (f"constexpr int kCF = {len(tb._CARRY_F)}, kCI = {len(tb._CARRY_I)}, "
            f"kOF = {len(tb._OUT_F)}, kOI = {len(tb._OUT_I)};") in src
