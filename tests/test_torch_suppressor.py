"""The ported suppressor path (``classifier_only_mode=False``, the engine's
default configuration) against the JAX engine: the engine's outputs over
its variants, ``istft``, the gain (kernel K5 runs its plain loop on the
CPU), ``RainDetectorProcessor`` metrics and state, and its engine-cache
key."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_processing_tools_tpu.config import DEFAULT_MODE_BANDS
from audio_processing_tools_tpu.config import build_noise_config as jbuild
from audio_processing_tools_tpu.models import spectral_noise as jsn
from audio_processing_tools_tpu.ops.windows import hann_window
from audio_processing_tools_tpu.utils.corpus import make_labeled_corpus

from audio_processing_tools_tpu_torch import _kernels
from audio_processing_tools_tpu_torch.config import build_noise_config
from audio_processing_tools_tpu_torch.models import spectral_noise as tsn
from audio_processing_tools_tpu_torch.ops.stft import istft

jstft = importlib.import_module("audio_processing_tools_tpu.ops.stft")

FS = 11162
DET = {"mode_bands": list(DEFAULT_MODE_BANDS)}
OUT = {"compute_output_audio": True, "return_spectra": True, "return_debug": True,
       "return_noise_psd": True}

VARIANTS = {
    "default": {},
    "audio_spectra_debug_psd": OUT,
    "wiener": {**OUT, "gain_mode": "wiener"},
    "fixed_gain": {**OUT, "adaptive_gain_enable": False},
    "snr_gate_mode_bands": {**OUT, "snr_gating_enable": True},
    "snr_gate_all_bins": {**OUT, "snr_gating_enable": True, "snr_gating_use_mode_bands": False},
    "snr_gate_power_2": {**OUT, "snr_gating_enable": True, "snr_gating_power": 2},
    "lagged_psd": {**OUT, "use_lagged_noise_psd": True},
    "suppressor_bypass": {**OUT, "suppressor_bypass": True},
    "bypass_classifier": {**OUT, "detector": {**DET, "bypass_classifier": True}},
    "pre_smooth_median": {**OUT, "pre_smooth_frames": 3, "median_frames": 4},
    "no_freq_smoothing": {**OUT, "gain_freq_smooth_enable": False},
}

# Bounds beyond the default 1e-5 of max|d|/max, each for a stated reason.
# The two engines' spectrograms differ in their last bits (two FFT
# libraries); at a low-power bin that is a relative change of ~6e-6 in P.
#  * Wiener's gain (P - o*N) / P moves by that relative change times o*N/P,
#    more than the square-root gain does.
#  * The pre-smoothed PSD runs through the JAX package's float32
#    running-sum difference (``causal_time_mean``), which cancels where
#    quiet bins follow loud ones.  The port adds in the JAX program's order
#    and gives its bits on equal input (``test_torch_trackers.py``), but the
#    cancellation amplifies the spectrograms' last-bit differences in the
#    quiet bins, and the gain and its products follow.
_BOUNDS = {
    ("wiener", "G"): 3e-5,
    ("pre_smooth_median", "G"): 2e-3,
    ("pre_smooth_median", "S_hat"): 1e-4,
    ("pre_smooth_median", "median_noise_floor_db"): 1e-4,
}


@pytest.fixture(scope="module")
def clips():
    x, _, kinds = make_labeled_corpus(seed=7, seconds=2.0)
    # two clips of each class keep the JAX compile per variant short
    keep = [i for i, k in enumerate(kinds) if kinds.index(k) + 2 > i]
    return x[keep]


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-6))


def _bound(variant, path):
    key = path.rsplit("/", 1)[-1]
    if (variant, key) in _BOUNDS:
        return _BOUNDS[(variant, key)]
    # the detector's dB-domain debug values: the log amplifies the
    # spectrograms' rounding at low-power bins
    return 1e-4 if any(s in path for s in ("/td_", "flux", "cepstrum")) else 1e-5


def _compare(got, ref, variant, path=""):
    if isinstance(ref, dict):
        assert set(got) == set(ref), (path, set(got) ^ set(ref))
        for k in ref:
            _compare(got[k], ref[k], variant, f"{path}/{k}")
        return
    if ref is None:
        assert got is None, path
        return
    if not isinstance(got, torch.Tensor):
        # a Python constant of the port; the vmapped JAX program repeats it per clip
        assert np.all(np.asarray(ref) == got), path
        return
    g, r = got.numpy(), np.asarray(ref)
    assert g.shape == r.shape, (path, g.shape, r.shape)
    if r.dtype.kind in "biu" or path.endswith(("frame_class", "rain_conf", "noise_conf")):
        np.testing.assert_array_equal(g, r, err_msg=path)
    elif r.dtype.kind == "c":
        b = _bound(variant, path)
        assert _rel(g.real, r.real) <= b and _rel(g.imag, r.imag) <= b, path
    else:
        assert _rel(g, r) <= _bound(variant, path), (path, _rel(g, r))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_suppressor_matches_jax_engine(clips, variant):
    params = {"detector": DET, **VARIANTS[variant]}
    ref = jsn.SpectralNoiseEngine(jbuild(FS, params)).process_batch(clips)
    _kernels.reset_launches()
    got = tsn.SpectralNoiseEngine(build_noise_config(FS, params), device="cpu").process_batch(clips)
    assert not any(_kernels.LAUNCHES.values())  # CPU tensors take the plain versions
    _compare(got, ref, variant)


@pytest.mark.parametrize("n_fft,hop,n", [(256, 128, 3000), (200, 75, 2000)],
                         ids=["hop_divides", "hop_does_not_divide"])
@pytest.mark.parametrize("extra", [-137, 411], ids=["shorter", "longer"])
def test_istft_matches_jax(n_fft, hop, n, extra):
    rng = np.random.default_rng(21)
    x = rng.standard_normal((2, n)).astype(np.float32)
    S = np.asarray(jstft.stft(jnp.asarray(x), n_fft=n_fft, hop=hop))
    length = n + extra
    got = istft(torch.from_numpy(S.copy()), n_fft=n_fft, hop=hop, length=length).numpy()
    ref = np.asarray(jstft.istft(jnp.asarray(S), n_fft=n_fft, hop=hop, length=length))
    assert got.shape == ref.shape == (2, length) and got.dtype == np.float32
    # the overlap-add before its normalization agrees everywhere; where the
    # summed squared window is tiny (the last samples of the last frame) the
    # division magnifies the two FFT libraries' rounding, so the normalized
    # output is held where that sum is at least 0.1
    T = S.shape[-1]
    wsq = np.zeros((T - 1) * hop + n_fft)
    w = hann_window(n_fft).astype(np.float64)
    for t in range(T):
        wsq[t * hop : t * hop + n_fft] += w ** 2
    wsq = np.where(wsq > 1e-10, wsq, 1.0)[n_fft // 2 :]
    wsq = np.pad(wsq, (0, max(0, length - wsq.size)))[:length]
    assert _rel(got * wsq, ref * wsq) <= 1e-5
    well = wsq >= 0.1
    assert _rel(got[:, well], ref[:, well]) <= 1e-5
    np.testing.assert_array_equal(got[:, wsq == 0], 0.0)
    np.testing.assert_array_equal(ref[:, wsq == 0], 0.0)


@pytest.mark.parametrize("adaptive", [True, False], ids=["adaptive", "fixed"])
def test_compute_gain_matches_jax(adaptive):
    """``gain_freq_stage`` and the plain loop of K5 against JAX
    ``compute_gain`` on equal inputs, noise-like and rain frames mixed."""
    rng = np.random.default_rng(22)
    B, K, T = 3, 17, 150
    P = (rng.gamma(1.0, 1.0, (B, K, T)) ** 2).astype(np.float32)
    N = (P * rng.uniform(0.0, 1.2, (B, K, T))).astype(np.float32)
    nc = rng.choice([0.0, 0.5, 0.7, 0.8, 0.95, 1.0, 1.3], (B, T)).astype(np.float32)
    gate = rng.random((B, T)).astype(np.float32)
    params = {"detector": DET, "adaptive_gain_enable": adaptive, "gain_smooth_alpha": 0.8,
              "gain_floor": 0.05, "gain_ceil": 0.97}
    cfg, jcfg = build_noise_config(FS, params), jbuild(FS, params)
    _kernels.reset_launches()
    got = tsn.compute_gain(cfg, torch.from_numpy(P), torch.from_numpy(N), torch.from_numpy(nc),
                           torch.from_numpy(gate)).numpy()
    assert _kernels.LAUNCHES["gain_time_smooth"] == 0
    ref = np.stack([np.asarray(jsn.compute_gain(jcfg, jnp.asarray(P[b]), jnp.asarray(N[b]),
                                                jnp.asarray(nc[b]), jnp.asarray(gate[b])))
                    for b in range(B)])
    assert got.shape == ref.shape
    assert _rel(got, ref) <= 1e-6
    assert got.min() >= 0.05 and got.max() <= 0.97


def _jax_time_smooth(jcfg, G, nc):
    """The temporal part of JAX ``compute_gain`` (``spectral_noise.py:165-
    178``) on a given ``G_freq`` (K, T), jitted as the engine runs it."""
    import jax

    def run(G, nc):
        nc = jnp.clip(nc, 0.0, 1.0)
        _, rest = jax.lax.scan(jsn.gain_time_step(jcfg), G[:, 0],
                               (jnp.moveaxis(G[:, 1:], -1, 0), nc[1:]), unroll=8)
        G_time = jnp.concatenate([G[:, :1], jnp.moveaxis(rest, 0, -1)], axis=-1)
        return jnp.clip(G_time, jcfg.gain_floor, jcfg.gain_ceil)

    return np.asarray(jax.jit(run)(jnp.asarray(G), jnp.asarray(nc)))


@pytest.mark.parametrize("case", ["time scan, inf and NaN gains", "compute_gain, NaN frames"])
@pytest.mark.parametrize("adaptive", [True, False], ids=["adaptive", "fixed"])
def test_gain_time_smooth_nonfinite_matches_jax(case, adaptive):
    """K5's plain loop against JAX on non-finite gains (inf, -inf and NaN
    in ``G_freq``; through the whole ``compute_gain``, NaN power frames
    make NaN gains) with noise confidences exactly 0.7 and NaN.  NaN and
    the clipped infinities land in the same places.  XLA CPU contracts the
    EMA ``alpha * G + (1 - alpha) * G_f`` into a fused multiply-add, which
    the port (and K5) does not, so finite values are held within 1e-6
    relative: always when not adaptive, and when adaptive wherever a frame
    had alpha > 0 (noise confidence above 0.7).  With every confidence at
    or below 0.7 (alpha 0 throughout, nothing to contract) the adaptive
    gain is JAX's, value for value."""
    rng = np.random.default_rng(23)
    B, K, T = 3, 9, 140
    nc = rng.choice([0.0, 0.5, 0.7, 0.8, 0.95, 1.0], (B, T)).astype(np.float32)
    nc[:, ::4] = 0.7
    nc[2, 30:33] = np.nan
    nc[0, 70] = np.nan
    params = {"detector": DET, "adaptive_gain_enable": adaptive, "gain_smooth_alpha": 0.8,
              "gain_floor": 0.05, "gain_ceil": 0.97}
    cfg, jcfg = build_noise_config(FS, params), jbuild(FS, params)
    if case.startswith("time scan"):
        G = rng.uniform(0.0, 1.2, (B, K, T)).astype(np.float32)
        G[0, 2, 10:13], G[1, 0, 0], G[2, 4, 50] = np.inf, np.nan, -np.inf
        G[0, 8, T - 1], G[1, 5, ::17], G[2, 1, 90:] = np.nan, np.inf, -np.inf
        got = tsn.gain_time_smooth(torch.from_numpy(G), torch.from_numpy(np.clip(nc, 0, 1)),
                                   cfg).numpy()
        ref = np.stack([_jax_time_smooth(jcfg, G[b], nc[b]) for b in range(B)])
        assert np.isinf(G).any() and np.isinf(got).sum() == 0  # clipped to the ceiling
    else:
        P = (rng.gamma(1.0, 1.0, (B, K, T)) ** 2).astype(np.float32)
        N = (P * rng.uniform(0.0, 1.2, (B, K, T))).astype(np.float32)
        P[0, :, 20], N[1, 3, 40:44], P[2, 6, 100] = np.nan, np.nan, np.nan
        got = tsn.compute_gain(cfg, torch.from_numpy(P), torch.from_numpy(N),
                               torch.from_numpy(nc)).numpy()
        ref = np.stack([np.asarray(jsn.compute_gain(jcfg, jnp.asarray(P[b]), jnp.asarray(N[b]),
                                                    jnp.asarray(nc[b]))) for b in range(B)])
    assert got.shape == ref.shape and np.isnan(ref).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(got[~fin], ref[~fin])
    assert _rel(got[fin], ref[fin]) <= 1e-6
    if adaptive and case.startswith("time scan"):
        low = np.where(nc > 0.7, 0.7, nc)  # NaN stays NaN
        got = tsn.gain_time_smooth(torch.from_numpy(G), torch.from_numpy(low), cfg).numpy()
        ref = np.stack([_jax_time_smooth(jcfg, G[b], low[b]) for b in range(B)])
        np.testing.assert_array_equal(got, ref)


def test_processor_metrics_and_state_match_jax(clips):
    params = {"sample_rate": FS, "clip_rain_min_frames": 3, "detector": DET}
    ref = jsn.RainDetectorProcessor().run_batch(clips, params)
    got = tsn.RainDetectorProcessor(device="cpu").run_batch(clips, params)
    for (gm, gs), (rm, rs) in zip(got, ref):
        assert set(gm) == set(rm) and set(gs) == set(rs)
        for k in ("mean_noise_floor_db", "median_noise_floor_db"):
            assert _rel(gm.pop(k), rm.pop(k)) <= 1e-5, k
        gm.pop("latency_s"), rm.pop("latency_s")
        assert gm == rm
        np.testing.assert_array_equal(gs["frame_class"], rs["frame_class"])

    one = {**params, "keep_state_debug": True}
    (gm, gs), (rm, rs) = (tsn.RainDetectorProcessor(device="cpu").run(clips[1], one),
                          jsn.RainDetectorProcessor().run(clips[1], one))
    assert set(gs) == set(rs) and {"debug", "det_debug", "noise_psd"} <= set(gs)
    assert set(gs["debug"]) == set(rs["debug"]) and set(gs["det_debug"]) == set(rs["det_debug"])
    assert _rel(gs["noise_psd"], rs["noise_psd"]) <= 1e-5
    for k in ("mean_noise_floor_db", "median_noise_floor_db"):
        assert _rel(gm.pop(k), rm.pop(k)) <= 1e-5
    gm.pop("latency_s"), rm.pop("latency_s")
    assert gm == rm


def test_processor_key_falls_back_to_repr():
    params = {"sample_rate": FS, "detector": DET, "labels": {("a", 1): "b"}}
    with pytest.raises(TypeError):
        __import__("json").dumps(params, sort_keys=True, default=str)
    assert tsn.RainDetectorProcessor._key(params) == jsn.RainDetectorProcessor._key(params)
    proc = tsn.RainDetectorProcessor(device="cpu")
    assert proc._engine(params) is proc._engine(dict(params))
