"""Port parity: the stage-2 time-domain confirmer (``models/time_domain.py``)
and its distance filter (``ops/peaks.py::select_peaks_by_distance``, kernel
K9's plain loop on the CPU) against the JAX package.

Tolerances against JAX:

  * the distance filter: the JAX loop's bits, the 64-step cap included,
    and so does a NumPy model of kernel K9's algorithm (candidates by rank
    among all positions, then a walk over words of covered positions) on
    non-finite and signed-zero peaks, caps among -inf and NaN ties, caps of
    0 and -1, short rows and distances below 2 and past the row;
  * the confirmer's ``confirmed_mask``, ``confirmed_counts``,
    ``candidate_peaks``, ``run_mask`` and each detail's peak indices:
    identical;
  * crest factor and kurtosis: within 1e-5 relative (float32 sums in the
    port's fixed pairwise order against XLA's own);
  * the Hilbert envelope and the mode signal: within 1e-5 of their maximum
    (two FFT libraries; the IIR's block form against JAX's scan).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_processing_tools_tpu.models import time_domain as jtd
from audio_processing_tools_tpu.ops.peaks import local_maxima as jlocal_maxima
from audio_processing_tools_tpu.ops.peaks import select_peaks_by_distance as jselect
from audio_processing_tools_tpu.utils.corpus import synth_clip

from chip_smoke import with_nonfinite_peaks

from audio_processing_tools_tpu_torch import _kernels
from audio_processing_tools_tpu_torch.config import DEFAULT_MODE_BANDS
from audio_processing_tools_tpu_torch.models import time_domain as ttd
from audio_processing_tools_tpu_torch.ops.peaks import (
    _select_peaks_by_distance_cuda,
    select_peaks_by_distance,
)

FS = 11162


def _pings(seed, seconds=2.0):
    """Noise with three damped multi-mode pings (``tests/test_time_domain.py``)."""
    rng = np.random.default_rng(seed)
    n = int(FS * seconds)
    x = 0.01 * rng.standard_normal(n)
    k = np.arange(600)
    ping = sum(a * np.sin(2 * np.pi * f * k / FS) for f, a in ((520, 1), (900, 0.5), (1600, 0.3)))
    for t0 in (4000, 9000, 14000):
        if t0 + 600 <= n:
            x[t0 : t0 + 600] += 0.7 * np.exp(-k / 50.0) * ping
    return x.astype(np.float32)


def _assert_same(got, ref):
    for key in ("confirmed_mask", "confirmed_counts", "candidate_peaks", "run_mask",
                "stage1_is_rain"):
        np.testing.assert_array_equal(got[key], np.asarray(ref[key]), err_msg=key)
        assert got[key].dtype == np.asarray(ref[key]).dtype, key
    for key in ("crest_factor", "kurtosis"):
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-5, atol=0, err_msg=key)
    assert len(got["details"]) == len(ref["details"])
    for g, r in zip(got["details"], ref["details"]):
        for key in ("frame_idx", "window", "confirmed", "confirmed_raindrops",
                    "n_candidate_peaks"):
            assert g[key] == r[key], key
        np.testing.assert_array_equal(g["peak_indices_local"], r["peak_indices_local"])
        assert g["peak_indices_local"].dtype == r["peak_indices_local"].dtype
    scale = np.abs(ref["x_mode"]).max()
    np.testing.assert_allclose(got["x_mode"], ref["x_mode"], rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("n", [256, 384, 255])
def test_hilbert_envelope_matches_jax(n):
    x = np.random.default_rng(n).standard_normal((3, n)).astype(np.float32)
    got = ttd.hilbert_envelope(torch.from_numpy(x)).numpy()
    ref = np.asarray(jax.jit(jtd.hilbert_envelope)(jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def _peak_rows(seed, n=384):
    """Rows for the distance filter: smooth noise with many maxima (more
    than 64), plateaus of equal heights, ties between separate peaks, a row
    with no peak and a row with a single one."""
    rng = np.random.default_rng(seed)
    rows = []
    many = rng.random(n).astype(np.float32)  # ~n/3 strict maxima
    rows.append(many)
    ties = np.round(rng.random(n) * 4).astype(np.float32)  # few levels: ties everywhere
    rows.append(ties)
    steps = np.repeat(rng.random(n // 8), 8).astype(np.float32)  # plateaus
    rows.append(steps + np.tile(np.array([0, 1, 0, 0, 0, 1, 0, 0], np.float32), n // 8))
    rows.append(np.zeros(n, np.float32))  # no peak
    one = np.zeros(n, np.float32)
    one[n // 3] = 1.0
    rows.append(one)
    smooth = np.convolve(rng.standard_normal(n + 20), np.ones(5) / 5, "valid")[:n]
    rows.append(smooth.astype(np.float32))
    x = np.stack(rows)
    is_peak = np.asarray(jlocal_maxima(jnp.asarray(x)))
    # a few non-maxima marked as peaks too, and maxima dropped: the filter
    # takes any mask
    flip = rng.random(x.shape) < 0.05
    return x, is_peak ^ flip


@pytest.mark.parametrize("distance", [1, 7, 45])
def test_select_peaks_by_distance_plain_matches_jax(distance):
    x, is_peak = _peak_rows(distance)
    assert int(is_peak[0].sum()) > 64  # the cap binds on this row
    ref = np.stack([np.asarray(jax.jit(jselect, static_argnums=(2,))(
        jnp.asarray(r), jnp.asarray(p), distance)) for r, p in zip(x, is_peak)])
    _kernels.reset_launches()
    got = select_peaks_by_distance(torch.from_numpy(x), torch.from_numpy(is_peak), distance)
    assert _kernels.LAUNCHES["select_peaks_by_distance"] == 0  # the CPU runs no kernel
    assert got.dtype == torch.bool and tuple(got.shape) == x.shape
    np.testing.assert_array_equal(got.numpy(), ref)
    # batched rows (and a leading axis) equal each row alone
    got3 = select_peaks_by_distance(torch.from_numpy(x).reshape(2, 3, -1),
                                    torch.from_numpy(is_peak).reshape(2, 3, -1), distance)
    np.testing.assert_array_equal(got3.reshape(x.shape).numpy(), ref)


@pytest.mark.parametrize("max_peaks", [3, 64, 1000])
def test_select_peaks_cap_is_part_of_the_function(max_peaks):
    """Peaks past the cap never clear others: equal to JAX at any cap."""
    x, is_peak = _peak_rows(11)
    ref = np.stack([np.asarray(jselect(jnp.asarray(r), jnp.asarray(p), 7, max_peaks))
                    for r, p in zip(x, is_peak)])
    got = select_peaks_by_distance(torch.from_numpy(x), torch.from_numpy(is_peak), 7,
                                   max_peaks=max_peaks)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_select_peaks_cuda_tensor_never_falls_back():
    """A CPU tensor takes the plain loop; the kernel's wrapper refuses one."""
    x, is_peak = _peak_rows(3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        _select_peaks_by_distance_cuda(torch.from_numpy(x), torch.from_numpy(is_peak), 7, 64)


def _k9_model(x, is_peak, distance, max_peaks):
    """A NumPy model of K9's algorithm (``csrc/peaks.cu``) on rows (R, n):
    the candidates are the peaks ranked below ``min(max_peaks, n)`` among
    all positions in the JAX order (tallest first, ties to the larger index,
    non-peaks as -inf, -0 equal to +0, NaN last); in rank order, a candidate
    not yet covered covers the positions of ``(p - d, p + d)`` but its own,
    in 32-bit words; the output is ``is_peak & ~covered``."""
    R, n = x.shape
    steps = max(min(max_peaks, n), 0)
    idx = np.arange(n)
    out = np.zeros((R, n), bool)
    for r in range(R):
        v = np.where(is_peak[r], x[r], np.float32(-np.inf)).astype(np.float64)
        nan = np.isnan(v)
        v = np.where(nan, -np.inf, v)
        # descending: numbers before NaN, then value (lexsort holds -0 equal
        # to +0), then index
        order = np.lexsort((idx, v, ~nan))[::-1]
        rank = np.empty(n, int)
        rank[order] = idx
        cand = sorted((int(rank[i]), int(i)) for i in np.flatnonzero(is_peak[r]) if rank[i] < steps)
        covered = np.zeros((n + 31) // 32, np.uint32)
        for _, p in cand:
            if (covered[p // 32] >> np.uint32(p % 32)) & 1:
                continue
            for i in range(max(p - distance + 1, 0), min(p + distance, n)):
                if i != p:
                    covered[i // 32] |= np.uint32(1 << (i % 32))
        bits = (covered[idx // 32] >> (idx % 32).astype(np.uint32)) & 1
        out[r] = is_peak[r] & (bits == 0)
    return out


def _k9_case(name):
    """``[(x, is_peak, distance, max_peaks), ...]`` for one of K9's paths."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name.startswith("peak rows"):
        d = int(name.split()[-1])
        return [(*_peak_rows(d), d, 64)]
    if name == "non-finite peaks":
        x, pk = _peak_rows(5)
        return [(with_nonfinite_peaks(x, pk, 5), pk, 7, cap) for cap in (64, 1000)]
    if name == "caps among -inf and NaN ties":
        # rows of -inf: 10 finite peaks, 70 peaks at -inf, 4 NaN peaks and 4
        # NaN non-peaks; non-peaks (as -inf) use up steps among the -inf ties
        n = 200
        x = np.full((4, n), -np.inf, np.float32)
        pk = np.zeros((4, n), bool)
        for r in range(4):
            pos = rng.permutation(n)
            x[r, pos[:10]] = rng.random(10)
            pk[r, pos[:84]] = True
            x[r, pos[80:88]] = np.nan
        return [(x, pk, 3, cap) for cap in (10, 18, 83, 197, 198, 200)]
    if name == "distances":
        x, pk = _peak_rows(8)
        return [(x, pk, d, 64) for d in (-5, 0, 2, 383, 384, 391)]
    if name == "short rows":
        out = []
        for n in (1, 2, 33):
            x = np.round(rng.random((6, n)) * 2).astype(np.float32)
            out += [(x, rng.random(x.shape) < 0.5, d, 64) for d in (1, 2, 45)]
        return out
    assert name == "exactly 64 and 65 peaks"
    out = []
    for peaks in (64, 65):
        x = rng.random((3, 384)).astype(np.float32)
        pk = np.zeros(x.shape, bool)
        for r in range(3):
            pk[r, rng.choice(384, peaks, replace=False)] = True
        out += [(x, pk, 45, cap) for cap in (64, 65)]
    return out


@pytest.mark.parametrize("name", ["peak rows 1", "peak rows 7", "peak rows 45",
                                  "non-finite peaks", "caps among -inf and NaN ties",
                                  "distances", "short rows", "exactly 64 and 65 peaks"])
def test_k9_algorithm_model_matches_jax(name):
    """K9's algorithm (candidates by rank among all positions, then the walk
    over covered words) gives JAX's bits, on the rows and settings that
    reach each of its paths; so does the port's plain loop."""
    for x, pk, d, cap in _k9_case(name):
        ref = np.asarray(jax.jit(jax.vmap(jselect, in_axes=(0, 0, None, None)),
                                 static_argnums=(2, 3))(jnp.asarray(x), jnp.asarray(pk), d, cap))
        np.testing.assert_array_equal(_k9_model(x, pk, d, cap), ref, err_msg=f"d {d}, cap {cap}")
        got = select_peaks_by_distance(torch.from_numpy(x), torch.from_numpy(pk), d, cap)
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=f"d {d}, cap {cap}")


@pytest.mark.parametrize("max_peaks", [0, -1])
def test_select_peaks_no_step_for_caps_below_one(max_peaks):
    """A cap of 0 or below runs no step, in JAX's ``fori_loop`` and the
    port's plain loop alike: the output is ``is_peak``."""
    x, is_peak = _peak_rows(13)
    ref = np.asarray(jax.vmap(lambda r, p: jselect(r, p, 7, max_peaks))(jnp.asarray(x),
                                                                     jnp.asarray(is_peak)))
    got = select_peaks_by_distance(torch.from_numpy(x), torch.from_numpy(is_peak), 7,
                                   max_peaks=max_peaks)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(ref, is_peak)


@pytest.mark.parametrize("bands,n", [(None, FS), (DEFAULT_MODE_BANDS, FS),
                                     (DEFAULT_MODE_BANDS, 20)])
def test_mode_signal_matches_jax(bands, n):
    """No bands (the operating band), the five default mode bands, and an
    input no longer than the pad length, which takes ``sosfilt``."""
    x = _pings(5)[:n]
    cfg_t = ttd.TimeDomainDetectorConfig(mode_bands=bands)
    cfg_j = jtd.TimeDomainDetectorConfig(mode_bands=bands)
    got = ttd._mode_signal(torch.from_numpy(x), cfg_t, FS).numpy()
    ref = np.asarray(jax.jit(lambda v: jtd._mode_signal(v, cfg_j, FS))(jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_confirmer_no_mask_matches_jax():
    x = _pings(1)
    params = {"sample_rate": FS, "detector": {"mode_bands": list(DEFAULT_MODE_BANDS)}}
    got = ttd.TimeDomainRainDetector(ttd.build_time_domain_config(params), device="cpu").process(x)
    ref = jtd.TimeDomainRainDetector(jtd.build_time_domain_config(params)).process(x)
    _assert_same(got, ref)
    assert got["confirmed_mask"].any() and not got["confirmed_mask"].all()


def test_confirmer_stage1_mask_matches_jax():
    """A random stage-1 mask over the engine's frame count (1 + n // hop, so
    the last windows are clipped to shorter lengths)."""
    x = _pings(2)
    T = 1 + x.size // 128
    mask = np.random.default_rng(9).random(T) < 0.4
    mask[4000 // 128] = True
    det = ttd.TimeDomainRainDetector(device="cpu")
    got = det.process(x, stage1_is_rain=mask, sr=FS)
    ref = jtd.TimeDomainRainDetector().process(x, stage1_is_rain=mask, sr=FS)
    _assert_same(got, ref)
    assert len(det._plans[(x.size, T)].groups) > 2  # clipped windows ran
    assert got["confirmed_mask"].any()


@pytest.mark.parametrize("draw", range(3))
def test_confirmer_fuzzed_config_matches_jax(draw):
    """Seeded configuration fuzz as ``tests/test_reference_differential.py:427-463``."""
    rng = np.random.default_rng(2000 + draw)
    over = {
        "prev_context_hops": int(rng.integers(0, 3)),
        "future_context_hops": int(rng.integers(0, 2)),
        "mode_bands": (None if rng.integers(0, 2) == 0
                       else tuple(tuple(b) for b in DEFAULT_MODE_BANDS[: int(rng.integers(1, 6))])),
        "operating_band": (float(rng.uniform(300.0, 500.0)), float(rng.uniform(2500.0, 4000.0))),
        "bp_order": int(rng.choice([2, 4])),
        "envelope_smooth_ms": float(rng.uniform(1.0, 4.0)),
        "peak_prominence_ratio": float(rng.uniform(0.15, 0.4)),
        "peak_distance_ms": float(rng.uniform(2.0, 8.0)),
        "min_crest_factor": float(rng.uniform(2.0, 4.0)),
        "min_kurtosis": float(rng.uniform(2.5, 5.0)),
    }
    half = synth_clip("rain_heavy", rng, fs=FS, seconds=1.0)
    rest = synth_clip("noise", rng, fs=FS, seconds=1.0)
    clip = np.concatenate([rest[: FS // 2], half, rest[FS // 2 :]])
    got = ttd.TimeDomainRainDetector(ttd.TimeDomainDetectorConfig(**over),
                                     device="cpu").process(clip, sr=FS)
    ref = jtd.TimeDomainRainDetector(jtd.TimeDomainDetectorConfig(**over)).process(clip, sr=FS)
    _assert_same(got, ref)


def test_confirmer_short_clip_raises():
    """A clip shorter than one frame has no window; JAX fails on its empty
    reductions, the port says why."""
    x = _pings(3)[:200]
    with pytest.raises(ValueError, match="no analysis window"):
        ttd.TimeDomainRainDetector(device="cpu").process(x)
    with pytest.raises(ValueError):
        jtd.TimeDomainRainDetector().process(x)


def test_build_time_domain_config_matches_jax():
    params = {
        "sample_rate": 8000, "n_fft": 512, "hop": 256, "operating_band": (300.0, 3000.0),
        "detector": {"mode_bands": [(450, 650), ("bad",), (800, 700), (1500.0, 1800.0)]},
        "time_domain": {"prev_context_hops": 2, "future_context_hops": 1, "bp_order": 2,
                        "envelope_smooth_ms": 3.0, "peak_prominence_ratio": 0.3,
                        "peak_distance_ms": 6.0, "min_crest_factor": 2.5,
                        "min_kurtosis": 4.0, "eps": 1e-8},
    }
    for p in (params, {}, {"sample_rate": FS}):
        got, ref = ttd.build_time_domain_config(p), jtd.build_time_domain_config(p)
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert ttd.build_time_domain_config(params).mode_bands == ((450.0, 650.0), (1500.0, 1800.0))
