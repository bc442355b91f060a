"""Port parity: the legacy RoE classifier (``models/roe.py``; kernels K1 and
K4 run their plain versions on the CPU) against the JAX package's
``models/roe.py``, which runs here on the XLA ``rfft`` path.

Tolerances against JAX:

  * configurations, band-mask rows, peak searches on equal input and the
    local average of the 3 smallest (``_local_average_sorted3``): identical;
  * per-clip counts (``rain_drop_count``, ``_mod``, ``_raw``,
    ``rain_peaks_count``) and the per-frame ``raining``, ``rain_peaks`` and
    ``rain_status_new``: identical;
  * ``frain_mean``: within 1e-6 of its value (a mean of up to 175 peak
    frequencies; the port sums in one fixed pairwise order, XLA in its own,
    which may move the last bit);
  * ``_novelty_spectrum`` and ``_pulse_characteristics`` on equal input:
    within 1e-5 of their maximum;
  * the float per-frame arrays of whole clips: within 1e-4 of their maximum
    (the dB-domain bound of ROADMAP R4: two FFT libraries, two filter sum
    orders).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_processing_tools_tpu.models import roe as jroe

from audio_processing_tools_tpu_torch.models import roe as troe

FS = 11162
PING_MODES = ((520.0, 1.0), (1040.0, 0.5), (1560.0, 0.35), (2080.0, 0.25))
# 5 s clips and a 6 s check duration: two full 2 s chunks and a short last
# one of 1 s, so both chunk lengths run
KW = {"check_duration": 6.0}


def _clips(seed, n_clips=2, seconds=5.0):
    """Even clips noise, odd clips quieter noise with sharp damped harmonic
    pings about eight times a second."""
    rng = np.random.default_rng(seed)
    n = int(FS * seconds)
    k = np.arange(800)
    ping = np.exp(-k / 50.0) * sum(a * np.sin(2 * np.pi * f * k / FS) for f, a in PING_MODES)
    out = np.empty((n_clips, n), np.float32)
    for i in range(n_clips):
        x = (0.02 if i % 2 == 0 else 0.006) * rng.standard_normal(n)
        if i % 2:
            for t0 in rng.integers(FS // 4, n - 1000, int(8 * seconds)):
                x[t0 : t0 + 800] += rng.uniform(0.3, 0.5) * ping
        out[i] = np.clip(x, -1.0, 1.0)
    return out


@pytest.fixture(scope="module")
def clips():
    return _clips(3)


@pytest.fixture(scope="module")
def batch(clips):
    return jroe.roe_detect_batch(clips, **KW), troe.roe_detect_batch(clips, device="cpu", **KW)


EXACT = ("rain_drop_count", "rain_drop_count_mod", "rain_drop_count_raw", "rain_peaks_count",
         "raining", "rain_peaks", "rain_status_new", "duration", "times")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _check_state(got, ref, float_bound=1e-4):
    assert set(got) == set(ref), set(got) ^ set(ref)
    for key, b in ref.items():
        a, b = np.asarray(got[key]), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, (key, a.shape, b.shape, a.dtype, b.dtype)
        if key in EXACT or b.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=key)
        elif key == "frain_mean":
            np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=key)
        else:
            assert _rel(a, b) <= float_bound, (key, _rel(a, b))


@pytest.mark.parametrize("params", [
    {},
    {"sample_rate": FS, "harmonic_threshold": [5, 4, 3, 3, 3, 3]},
    {"check_duration": 6.0, "ns_duration_ms": 600.0, "freq_resolution": 20,
     "op_freq_range": (300, 3000), "handle_fp": False, "unknown_key": 1},
])
def test_config_derivations(params):
    got, ref = troe.build_roe_config(**params), jroe.build_roe_config(**params)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    for prop in ("frame_length", "hop_length", "min_average_len", "rain_thr_hn"):
        assert getattr(got, prop) == getattr(ref, prop), prop


@pytest.mark.parametrize("M", [20, 5, 30])
def test_local_average_sorted3_bits(M):
    """The topk form gives the bits of JAX's rank selection (M = 20, 5: the
    3 smallest) and top_k (M = 30: the 5 smallest), ties included; a zero
    average may carry the other sign, which compares equal."""
    rng = np.random.default_rng(M)
    x = np.abs(rng.standard_normal((3, 176))).astype(np.float32)
    x[:, 40:60] = 0.25  # a run of ties
    x[1, ::7] = 0.0
    got = troe._local_average_sorted3(torch.from_numpy(x), M).numpy()
    jfn = jax.jit(jroe._local_average_sorted3, static_argnums=1)
    ref = np.stack([np.asarray(jfn(jnp.asarray(r), M)) for r in x])
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)
    nz = ref != 0
    np.testing.assert_array_equal(got[nz].view(np.int32), ref[nz].view(np.int32))


def test_novelty_spectrum_matches_jax():
    rng = np.random.default_rng(5)
    Y = np.abs(rng.standard_normal((4, 129, 175))).astype(np.float32)
    Y[:, :10] = 0
    Y[:, 40:] = 0
    nov_t, nov1 = troe._novelty_spectrum(torch.from_numpy(Y), 20, 4.5)
    jfn = jax.jit(jroe._novelty_spectrum, static_argnums=(1, 2))
    for i in range(Y.shape[0]):
        rt, r1 = (np.asarray(a) for a in jfn(jnp.asarray(Y[i]), 20, 4.5))
        assert _rel(nov_t[i].numpy(), rt) <= 1e-5 and _rel(nov1[i].numpy(), r1) <= 1e-5
        np.testing.assert_array_equal(nov_t[i].numpy() > 0, rt > 0)


def test_pulse_characteristics_match_jax():
    cfg = troe.RoeConfig()
    rng = np.random.default_rng(6)
    n = 22324
    x = (0.1 * rng.standard_normal((2, n))).astype(np.float32)
    x[:, 5000:5200] += 0.8 * np.exp(-np.arange(200) / 30.0)
    T = 1 + n // 128
    got = troe._pulse_characteristics(torch.from_numpy(x), T, cfg)
    jfn = jax.jit(jroe._pulse_characteristics, static_argnums=(1, 2))
    for i in range(2):
        ref = jfn(jnp.asarray(x[i]), T, jroe.RoeConfig())
        assert set(got) == set(ref)
        for key in ref:
            assert _rel(got[key][i].numpy(), np.asarray(ref[key])) <= 1e-5, key


def test_band_masks_and_peak_search_match_jax():
    """Band rows from data-dependent edges, and the first-peak search, on
    equal input, identical: compiled, XLA multiplies by the float32
    reciprocal of each constant divisor, and so does the port."""
    rng = np.random.default_rng(7)
    f1 = (400 + 300 * rng.random(64)).astype(np.float32)
    got = troe._band_mask_bins(torch.from_numpy(f1), torch.from_numpy(f1 + 300), FS, 256, 129)
    jmask = jax.jit(jax.vmap(lambda a: jroe._band_mask_bins(a, a + 300.0, FS, 256, 129)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jmask(jnp.asarray(f1))))
    mag = np.abs(rng.standard_normal((3, 129, 175))).astype(np.float32)
    mag[:, :, ::5] = np.arange(129, dtype=np.float32)[:, None]  # frames without a peak
    lo = np.float32([400.0, 650.0, 1200.0])
    found, fpeak = troe._find_first_peak_in_range(
        torch.from_numpy(mag), torch.from_numpy(lo), torch.from_numpy(lo + 900), torch.from_numpy(lo),
        torch.from_numpy(lo + 300), FS, 3)
    jpeak = jax.jit(jax.vmap(lambda m, a: jroe._find_first_peak_in_range(
        m, a, a + 900.0, a, a + 300.0, FS, 3)))
    rf, rp = jpeak(jnp.asarray(mag), jnp.asarray(lo))
    np.testing.assert_array_equal(found.numpy(), np.asarray(rf))
    np.testing.assert_array_equal(fpeak.numpy(), np.asarray(rp))
    assert 0 < int(found.sum()) < found.numel()


def test_roe_detect_batch_matches_jax(batch):
    ref, got = batch
    _check_state(got, ref)
    # the clips exercise the decision chain: the ping clip rains
    assert ref["rain_drop_count_mod"][1] > 0 and ref["rain_drop_count_mod"][0] == 0
    assert got["raining"].shape[-1] == 3 * 1 + 175 * 2 + 88  # two full chunks, one short


def test_rain_detection_algo_matches_jax(clips):
    x = clips[1, : 4 * FS]
    kw = {"check_duration": 4.0}
    mod, frain, state = troe.rain_detection_algo(x, device="cpu", **kw)
    jmod, jfrain, jstate = jroe.rain_detection_algo(x, **kw)
    assert mod == jmod > 0
    assert frain == pytest.approx(jfrain, rel=1e-6)
    assert "spectrum_db0" in state and "spectrum_db" in state
    np.testing.assert_array_equal(state.pop("audio_data"), jstate.pop("audio_data"))
    _check_state(state, jstate)
    assert troe.python_classifier_boolean_wrapper(x, device="cpu", **kw) is True
    assert troe.python_classifier_boolean_wrapper(clips[0, : 4 * FS], device="cpu", **kw) is False


def test_batch_equals_single_clips(clips, batch):
    """Chunks as rows of one batch give each clip's own bits."""
    _, got = batch
    for i in range(clips.shape[0]):
        mod, frain, state = troe.rain_detection_algo(clips[i], device="cpu",
                                                     return_spectra=False, **KW)
        assert mod == got["rain_drop_count_mod"][i] and frain == got["frain_mean"][i]
        for key in ("raining", "nov", "kurtosis", "filtered", "rain_peaks"):
            np.testing.assert_array_equal(state[key], got[key][i], err_msg=key)


def test_sweep_features_and_thresholds_match_jax(clips):
    feats = troe.roe_sweep_features(clips, device="cpu", **KW)
    jfeats = jroe.roe_sweep_features(clips, **KW)
    assert dataclasses.asdict(feats["cfg"]) == dataclasses.asdict(jfeats["cfg"])
    np.testing.assert_array_equal(feats["nopeak"].numpy(), np.asarray(jfeats["nopeak"]))
    for key in ("nov1", "kurtosis", "crest_factor", "diff_energy"):
        assert _rel(feats[key].numpy(), np.asarray(jfeats[key])) <= 1e-4, key
    grid = [
        {"harmonic_threshold": (4.5, 4.0, 3.5, 3.5, 3.5, 3.5), "kurtosis_thr": 2.5,
         "crest_thr": 3.75, "diff_energy_thr": 6.5, "min_drop_count": 0.3,
         "rain_drop_min_thr": 3, "rain_drop_max_thr": 50, "rain_peaks_min_thr": 9,
         "rain_peaks_max_thr": 30},
        {"harmonic_threshold": (3.0, 3.0, 2.5, 2.5, 2.5, 2.5), "kurtosis_thr": 1.5,
         "crest_thr": 3.0, "diff_energy_thr": 4.0, "min_drop_count": np.float32(0.5),
         "rain_drop_min_thr": 1, "rain_drop_max_thr": 20, "rain_peaks_min_thr": 2,
         "rain_peaks_max_thr": 10},
        {"harmonic_threshold": (6.0, 5.0, 4.5, 4.0, 4.0, 4.0), "kurtosis_thr": 3.0,
         "crest_thr": 4.5, "diff_energy_thr": 8.0, "min_drop_count": 0.1,
         "rain_drop_min_thr": 5, "rain_drop_max_thr": 80, "rain_peaks_min_thr": 12,
         "rain_peaks_max_thr": 40},
    ]
    counts = []
    for thr in grid:
        got = troe.roe_apply_thresholds(feats, **thr)
        ref = np.asarray(jroe.roe_apply_thresholds(jfeats, **thr))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=str(thr))
        counts.append(got.numpy())
    assert len({tuple(c) for c in counts}) > 1  # the grid moves the decision


def test_nf_raises():
    with pytest.raises(NotImplementedError, match="nf != 0"):
        troe.roe_detect_batch(np.zeros((1, 3 * FS), np.float32), device="cpu", nf=1.0)
    with pytest.raises(ValueError, match="too short"):
        troe.roe_detect_batch(np.zeros((1, FS - 1), np.float32), device="cpu")
