"""Port parity at the geometries the JAX package runs beyond the main path:
the engine at other FFT sizes and hops, the live detector with audio out
at other sizes and with a long frequency smoother, band noise with wide
filters, wide rings and more subframes than ring slots, the confirmer's
long windows, long sweeps and wide cascades.  Each case holds the port's
CPU path (every kernel wrapper runs its plain version) against the JAX
package on the same seeded inputs, under the bounds of the module's own
parity tests.  Besides, the pure host functions that choose a kernel's
route or cut its work: K1's route, K10's frame segments, K7's groups of
sections, K9's route and K6's.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_processing_tools_tpu.models import band_noise as jb
from audio_processing_tools_tpu.ops import filters as jf

from audio_processing_tools_tpu_torch import _kernels
from audio_processing_tools_tpu_torch.models import band_noise as tb
from audio_processing_tools_tpu_torch.ops import filters as tf

FS = 11162


# ---------------------------------------------------------------------------
# Band noise: wide filters, wide rings, more subframes than slots
# ---------------------------------------------------------------------------


def _bn_signal(seed, seconds=3.0):
    """Noise with loud 520 Hz bursts every second (``tests/test_band_noise.py:225-232``)."""
    rng = np.random.default_rng(seed)
    n = int(FS * seconds)
    x = 0.01 * rng.standard_normal(n)
    k = np.arange(2500)
    for t0 in range(FS // 2, n - 3000, FS):
        x[t0 : t0 + 2500] += 0.5 * np.exp(-k / 400.0) * np.sin(2 * np.pi * 520 * k / FS)
    return x.astype(np.float32)


BN_GEOMETRIES = {
    "bpf_order_10": {"bpf_order": 10},
    "hp_order_18": {"hp_order": 18},
    "W_100": {"W": 100, "W_min": 10},
    "S_13": {"subhop": 32},
    "S_16": {"subframe_len": 32, "subhop": 32, "W": 128},
    # more subframes than slots: colliding pushes are summed, the count passes W
    "W_3_S_4": {"W": 3, "W_min": 1},
    "W_4_S_7": {"W": 4, "W_min": 2, "subhop": 64},
    # three and more colliding subframes: four into a slot, all seven into one
    "W_2_S_7": {"W": 2, "W_min": 1, "subhop": 64},
    "W_1_S_7": {"W": 1, "W_min": 1, "subhop": 64},
}


@pytest.mark.parametrize("name", list(BN_GEOMETRIES))
def test_band_noise_geometry_matches_jax(name):
    from tests.test_torch_band_noise import _assert_matches_jax, _host

    kw = BN_GEOMETRIES[name]
    clips = np.stack([_bn_signal(s) for s in (1, 2)])
    jcfg, tcfg = jb.BandNoiseEstimatorConfig(**kw), tb.BandNoiseEstimatorConfig(**kw)
    ref = _host(jax.vmap(lambda v: jb.band_noise_process(v, jcfg))(jnp.asarray(clips)))
    _kernels.reset_launches()
    got = _host(tb.band_noise_process(torch.from_numpy(clips), tcfg, device="cpu"))
    assert all(v == 0 for v in _kernels.LAUNCHES.values())
    _assert_matches_jax(got, ref)
    if name in ("W_1_S_7", "W_2_S_7", "W_3_S_4", "W_4_S_7"):
        # the JAX count of pushes that found their slot invalid passes W
        assert got["noise_buffer_valid_count"].max() > tcfg.W


# ---------------------------------------------------------------------------
# The engine at other FFT sizes and hops
# ---------------------------------------------------------------------------

ENGINE_GEOMETRIES = {"384_192": (384, 192), "2048_1024": (2048, 1024), "256_100": (256, 100)}


@pytest.fixture(scope="module")
def engine_clips():
    from audio_processing_tools_tpu.utils.corpus import make_labeled_corpus

    x, _, kinds = make_labeled_corpus(seed=7, seconds=2.0)
    keep = [i for i, k in enumerate(kinds) if kinds.index(k) == i]  # a clip of each class
    return x[keep]


@pytest.mark.parametrize("mode", ["classifier_only", "audio_out"])
@pytest.mark.parametrize("geometry", list(ENGINE_GEOMETRIES))
def test_engine_geometry_matches_jax(engine_clips, geometry, mode):
    """Frame classes and confidences exact, the rest under the suppressor
    tests' bounds (``tests/test_torch_suppressor.py::_bound``)."""
    from audio_processing_tools_tpu.config import DEFAULT_MODE_BANDS
    from audio_processing_tools_tpu.config import build_noise_config as jbuild
    from audio_processing_tools_tpu.models import spectral_noise as jsn
    from audio_processing_tools_tpu_torch.config import build_noise_config
    from audio_processing_tools_tpu_torch.models import spectral_noise as tsn
    from tests.test_torch_suppressor import _compare

    n_fft, hop = ENGINE_GEOMETRIES[geometry]
    params = {"n_fft": n_fft, "hop": hop, "detector": {"mode_bands": list(DEFAULT_MODE_BANDS)}}
    params.update({"classifier_only_mode": True} if mode == "classifier_only"
                  else {"compute_output_audio": True})
    ref = jsn.SpectralNoiseEngine(jbuild(FS, params)).process_batch(engine_clips)
    _kernels.reset_launches()
    got = tsn.SpectralNoiseEngine(build_noise_config(FS, params),
                                  device="cpu").process_batch(engine_clips)
    assert not any(_kernels.LAUNCHES.values())
    assert got["frame_class"].shape[-1] == 1 + engine_clips.shape[-1] // hop
    _compare(got, ref, "default")


# ---------------------------------------------------------------------------
# The live detector with audio out at other sizes, and a long smoother
# ---------------------------------------------------------------------------

STREAM_GEOMETRIES = {
    "384_192": {"n_fft": 384, "hop": 192},
    "2048_1024": {"n_fft": 2048, "hop": 1024},
    "11_taps": {"gain_freq_kernel": [1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 5.0, 4.0, 3.0, 2.0, 1.0]},
    # the TD prefilter past K7's 8 sections: 9 high-pass sections
    "hp_order_18": {"hp_order": 18},
}


@pytest.mark.parametrize("geometry", list(STREAM_GEOMETRIES))
def test_streaming_geometry_matches_jax(geometry):
    """``test_matches_the_jax_detector``'s bounds: classes exact, the denoised
    audio within 1e-4 of its maximum; 2 s of rain in two chunks."""
    from tests.test_torch_streaming import AUDIO, _jax, _port, _rain, _rel, _run

    params = {**AUDIO, **STREAM_GEOMETRIES[geometry]}
    hop = params.get("hop", 128)
    x = _rain(3, seconds=2.0)
    x = x[: x.size // hop * hop]
    sizes = [x.size // hop // 2 * hop]
    _kernels.reset_launches()
    got, _ = _run(_port(params), x, sizes)
    assert not any(_kernels.LAUNCHES.values())
    ref, _ = _run(_jax(params), x, sizes)
    for k in ("frame_class", "rain_conf", "noise_conf", "times"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert got["y"].shape == ref["y"].shape == (x.size,)
    assert _rel(got["y"], ref["y"]) <= 1e-4


# ---------------------------------------------------------------------------
# The confirmer's long windows, a long sweep, wide cascades
# ---------------------------------------------------------------------------


def test_confirmer_long_windows_match_jax():
    """``prev_context_hops=7`` at 256/128: windows of 7 * 128 + 256 = 1,152
    positions, past K9's warp route."""
    from audio_processing_tools_tpu.models import time_domain as jtd
    from audio_processing_tools_tpu_torch.models import time_domain as ttd
    from tests.test_torch_time_domain import _assert_same, _pings

    x = _pings(4)
    over = {"prev_context_hops": 7}
    got = ttd.TimeDomainRainDetector(ttd.TimeDomainDetectorConfig(**over),
                                     device="cpu").process(x, sr=FS)
    ref = jtd.TimeDomainRainDetector(jtd.TimeDomainDetectorConfig(**over)).process(x, sr=FS)
    _assert_same(got, ref)
    assert got["confirmed_mask"].any()


def test_decision_counts_long_clip_matches_jax():
    """T = 14,433, one frame past a K10 launch: the plain counts against the
    JAX sweep's ``eval_combo`` expression."""
    from audio_processing_tools_tpu_torch.ops import sweep as tsw

    rng = np.random.default_rng(11)
    B, T = 2, 14433
    feats = {k: rng.gamma(1.5, 1.0, (B, T)).astype(np.float32) for k in tsw.FEATURES}
    feats["td_crest"] = rng.uniform(0.0, 5.0, (B, T)).astype(np.float32)
    thr = {"pm": [0.5, 1.0], "m1": [0.6, 1.2], "m2": [0.4, 0.9], "m3": [0.7, 1.1],
           "msc": [1, 2], "tdg": [1.0, 2.5]}
    params = tsw.sweep_params(thr["pm"], thr["m1"], thr["m2"], thr["m3"], thr["msc"], thr["tdg"],
                              "cpu")
    got = tsw.decision_counts({k: torch.from_numpy(v) for k, v in feats.items()}, params)
    jf_ = {k: jnp.asarray(v) for k, v in feats.items()}

    def eval_combo(pm, m1v, m2v, m3v, mscv, tdgv):  # grid_search.py:231-241, the counts
        gate = (jf_["td_crest"] > tdgv).astype(jnp.float32)
        f0 = jnp.log1p(jnp.maximum(jf_["primary"] * gate, 0.0))
        f1 = jnp.log1p(jnp.maximum(jf_["s1"] * gate, 0.0))
        f2 = jnp.log1p(jnp.maximum(jf_["s2"] * gate, 0.0))
        f3 = jnp.log1p(jnp.maximum(jf_["s3"] * gate, 0.0))
        hits = ((f1 >= m1v).astype(jnp.int32) + (f2 >= m2v).astype(jnp.int32)
                + (f3 >= m3v).astype(jnp.int32))
        return jnp.sum((f0 >= pm) & (hits >= mscv), axis=-1)

    args = [jnp.asarray(thr[k], jnp.float32) for k in ("pm", "m1", "m2", "m3")]
    args += [jnp.asarray(thr["msc"], jnp.int32), jnp.asarray(thr["tdg"], jnp.float32)]
    ref = np.asarray(jax.jit(jax.vmap(eval_combo))(*args))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref.min() > 0


def _wide_sos(n_sections, kind="bandpass"):
    """Band noise's own designs: the band-pass at ``bpf_order = S`` or the
    350 Hz high-pass at ``hp_order = 2 S``, S sections each."""
    if kind == "highpass":
        return tb._design_filters(tb.BandNoiseEstimatorConfig(hp_order=2 * n_sections))[0]
    return tb._design_filters(tb.BandNoiseEstimatorConfig(bpf_order=n_sections))[1]


@pytest.mark.parametrize("kind,n_sections",
                         [("bandpass", 9), ("bandpass", 10), ("bandpass", 16), ("highpass", 9)])
def test_wide_cascades_match_jax(kind, n_sections):
    """``cascade_sosfilt`` (K4's plain version) against the JAX
    ``boundary="scan"`` cascade and ``sosfilt(zi)`` (K7's plain loop) against
    the JAX ``sosfilt`` with ``zi``, from a nonzero state: within 1e-5 of
    the JAX maximum (``test_cascade_scan_matches_jax_and_scipy``'s bound).
    The high-pass at ``hp_order = 18`` is the live prefilter's design past
    K7's 8 sections; its poles near z = 1 are where a float32 Direct Form
    step that forms ``b1 x - a1 y`` loses the state's low bits."""
    sos = _wide_sos(n_sections, kind)
    assert sos.shape[0] == n_sections
    rng = np.random.default_rng(n_sections)
    x = (0.1 * rng.standard_normal((2, 128 * 6 + 37))).astype(np.float32)
    zi = (0.01 * rng.standard_normal((2, n_sections, 2))).astype(np.float32)
    y, zf = tf.cascade_sosfilt(sos, torch.from_numpy(x), torch.from_numpy(zi))
    yj, zfj = jf._sosfilt_cascade_matmul(sos, jnp.asarray(x), jnp.asarray(zi), boundary="scan",
                                         return_zf=True)
    y7, zf7 = tf.sosfilt(sos, torch.from_numpy(x), torch.from_numpy(zi))
    yj7, zfj7 = jf.sosfilt(sos, jnp.asarray(x), zi=jnp.asarray(zi))
    for got, ref in ((y, yj), (zf, zfj), (y7, yj7), (zf7, zfj7)):
        ref = np.asarray(ref, np.float64)
        assert got.shape == ref.shape
        assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


def test_low_cutoff_highpass_sosfilt_zi_matches_jax():
    """The live prefilter's 4th-order high-pass at 100 Hz (2 sections) from
    a nonzero state: y and zf within 1e-5 of the JAX maximum, through
    ``sosfilt`` (a float64 state: the design's noise gain, 3,474, passes
    K7_FLOAT32_MAX_GAIN) and through the plain loop with a float32 state.
    Scipy's form of the step, (b1 x - a1 y) + z1, cancels b1 against a1 b0
    there and ended 5.9e-5 of zf's maximum from JAX; JAX's state-space form
    with bv formed in float64 does not."""
    sos = tf.design_highpass(FS, 100.0, 4)
    rng = np.random.default_rng(0)
    x = (0.1 * rng.standard_normal((2, 128 * 6 + 37))).astype(np.float32)
    zi = (0.01 * rng.standard_normal((2, sos.shape[0], 2))).astype(np.float32)
    y, zf = tf.sosfilt(sos, torch.from_numpy(x), torch.from_numpy(zi))
    y32, zf32 = tf._sosfilt_zi_plain(torch.from_numpy(tf._sos_coefficients(sos)),
                                     torch.from_numpy(x), torch.from_numpy(zi))
    yj, zfj = jf.sosfilt(sos, jnp.asarray(x), zi=jnp.asarray(zi))
    assert zf.dtype == torch.float64 and zf32.dtype == torch.float32
    for got, ref in ((y, yj), (zf, zfj), (y32, yj), (zf32, zfj)):
        ref = np.asarray(ref, np.float64)
        assert np.abs(got.double().numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


def _scipy_same_constants(sos, x, zi):
    """Scipy's float64 ``sosfilt`` of JAX's float32 section constants
    (``_sos_coefficients``), from ``zi`` (R, S, 2): ``(y, zf)``."""
    from scipy import signal

    S = sos.shape[0]
    b0, bv0, bv1, a1, a2 = tf._sos_coefficients(sos).astype(np.float64).T
    same = np.stack([b0, bv0 + a1 * b0, bv1 + a2 * b0, np.ones(S), a1, a2], axis=1)
    y, zf = signal.sosfilt(same, np.asarray(x, np.float64), axis=-1,
                           zi=np.asarray(zi, np.float64).transpose(1, 0, 2))
    return y, zf.transpose(1, 0, 2)


#: F7's designs (high-pass cutoff Hz, order), where a float32 state's error
#: reaches 1e-5 of y's or zf's maximum, and the two default prefilters
F7_DESIGNS = {"hp 60 o4": (60.0, 4), "hp 60 o8": (60.0, 8), "hp 100 o15": (100.0, 15),
              "hp 100 o16": (100.0, 16), "hp 350 o32": (350.0, 32),
              "default hp 350 o4": (350.0, 4), "default bp 400-3500 o4": None}


@pytest.mark.parametrize("name", list(F7_DESIGNS))
def test_f7_hard_designs_take_a_float64_state(name):
    """F7: at designs whose float32 state loses bits, ``sosfilt`` (K7's
    plain loop) keeps a float64 state and its y and zf are within 1e-5 of
    the maxima of scipy's float64 run of the same constants, and within
    1e-5 of JAX wherever JAX is itself within 1e-5 of float64; the two
    default prefilters keep a float32 state under the same bound."""
    design = F7_DESIGNS[name]
    sos = (tf.design_bandpass(FS, 400.0, 3500.0, 4) if design is None
           else tf.design_highpass(FS, *design))
    rng = np.random.default_rng(7)
    x = (0.1 * rng.standard_normal((2, 128 * 6 + 37))).astype(np.float32)
    zi = (0.01 * rng.standard_normal((2, sos.shape[0], 2))).astype(np.float32)
    y, zf = tf.sosfilt(sos, torch.from_numpy(x), torch.from_numpy(zi))
    assert zf.dtype == (torch.float32 if name.startswith("default") else torch.float64)
    yj, zfj = (np.asarray(v, np.float64) for v in jf.sosfilt(sos, jnp.asarray(x),
                                                             zi=jnp.asarray(zi)))
    for got, ref, jax_ in zip((y, zf), _scipy_same_constants(sos, x, zi), (yj, zfj)):
        got = got.double().numpy()
        scale = np.abs(ref).max()
        assert np.abs(got - ref).max() <= 1e-5 * scale
        if np.abs(jax_ - ref).max() <= 1e-5 * scale:
            assert np.abs(got - jax_).max() <= 1e-5 * np.abs(jax_).max()


@pytest.mark.parametrize("kind,n_sections",
                         [("highpass", 9), ("highpass", 16), ("bandpass", 10), ("bandpass", 16)])
def test_sosfilt_zi_double_state_is_exact(kind, n_sections):
    """Past 8 sections K7's plain loop keeps each section's state in float64
    and rounds only each section's output to float32: against scipy's
    float64 ``sosfilt`` of the same constants (JAX's float32 ones), y and zf
    within 1e-6 of their maxima.  What is left between the port and JAX
    there is JAX's own float32 rounding."""
    from scipy import signal

    sos = _wide_sos(n_sections, kind)
    rng = np.random.default_rng(100 + n_sections)
    x = (0.1 * rng.standard_normal((2, 128 * 6 + 37))).astype(np.float32)
    zi = 0.01 * rng.standard_normal((2, n_sections, 2))
    y, zf = tf.sosfilt(sos, torch.from_numpy(x), torch.from_numpy(zi))
    assert y.dtype == torch.float32 and zf.dtype == torch.float64
    b0, bv0, bv1, a1, a2 = tf._sos_coefficients(sos).astype(np.float64).T
    same = np.stack([b0, bv0 + a1 * b0, bv1 + a2 * b0, np.ones(n_sections), a1, a2], axis=1)
    ref, zref = signal.sosfilt(same, x.astype(np.float64), axis=-1, zi=zi.transpose(1, 0, 2))
    zref = zref.transpose(1, 0, 2)
    assert np.abs(y.numpy() - ref).max() <= 1e-6 * np.abs(ref).max()
    assert np.abs(zf.numpy() - zref).max() <= 1e-6 * np.abs(zref).max()


# ---------------------------------------------------------------------------
# The host functions that choose a kernel's route or cut its work
# ---------------------------------------------------------------------------


def test_k1_route_table():
    """The FFT for the main path's sizes, the mixed-radix FFT for every even
    size whose half has no odd prime factor above 31 (the JAX Pallas set
    n_fft % 128 == 0 with hop = n_fft / 2 among them, and the power-of-two
    sizes at a hop not a multiple of 4), the odd mixed-radix FFT for an odd
    size with such factors, the chirp-z transform for the rest, and the
    four-step FFT in device memory past one block's frame, or the split of
    the complex length at its one prime above 31 there (58,113 = 587 x 99),
    or the whole-length chirp-z transform on chip where L does not split
    (7,013 is prime); the DFT for none; refusals only below 1."""
    from audio_processing_tools_tpu_torch.ops import spectrogram as tspec

    table = {(256, 128): "fft", (256, 100): "fft", (64, 32): "fft", (1024, 512): "fft",
             (384, 192): "mixed", (640, 320): "mixed", (768, 384): "mixed",
             (2048, 1024): "mixed", (400, 200): "mixed", (256, 6): "mixed", (260, 128): "mixed",
             (32, 16): "mixed", (4096, 2048): "mixed", (385, 192): "mixed_odd",
             (296, 148): "chirpz", (16384, 8192): "global", (2, 1): "chirpz", (1, 1): "chirpz",
             (tspec.DFT_MAX_N_FFT + 1, 128): "split", (7013, 3506): "cluster"}
    for (n_fft, hop), route in table.items():
        assert tspec.k1_route(n_fft, hop) == route, (n_fft, hop)
    for n_fft in range(128, 4097, 128):  # the JAX Pallas kernel's geometries
        assert tspec.k1_route(n_fft, n_fft // 2) in ("fft", "mixed")
    assert tspec.launch_plan(256, 128) == (32, 68_744)
    for bad in ((256, 0), (0, 128)):
        with pytest.raises(ValueError):
            tspec.k1_route(*bad)
    # the DFT route, forced for comparisons, holds one frame's samples
    # within the kernel's own shared-memory limit in its last plan
    src = (Path(tspec.__file__).parent.parent / "csrc" / "spectrogram_power.cu").read_text()
    assert f"constexpr int kSmemLimit = {tspec.SMEM_LIMIT};" in src
    assert "{1, 1, false, dft_samples_bytes(n_fft, 1)}" in src
    assert tspec.DFT_MAX_N_FFT * 4 <= tspec.SMEM_LIMIT < (tspec.DFT_MAX_N_FFT + 1) * 4


def test_k10_segments_and_clip_blocks():
    from audio_processing_tools_tpu_torch.ops import sweep as tsw

    for T in (0, 1, 873, tsw.K10_MAX_FRAMES, tsw.K10_MAX_FRAMES + 1, 14433, 52322, 100_000):
        segs = tsw.k10_segments(T)
        assert sum(b - a for a, b in segs) == T
        assert all(0 < b - a <= tsw.K10_MAX_FRAMES for a, b in segs)
        assert all(b0 == a1 for (_, b0), (a1, _) in zip(segs, segs[1:]))
    assert tsw.k10_segments(873) == [(0, 873)]
    blocks = tsw.k10_clip_blocks(70_000)
    assert blocks == [(0, 65535), (65535, 70_000)]


def test_k10_segment_counts_add_up():
    """A clip's count is the sum of its segments' counts (the rule decides
    frame by frame), which K10's segmented launches rely on."""
    from audio_processing_tools_tpu_torch.ops import sweep as tsw

    rng = np.random.default_rng(12)
    feats = {k: torch.from_numpy(rng.gamma(1.5, 1.0, (3, 500)).astype(np.float32))
             for k in tsw.FEATURES}
    params = tsw.sweep_params([0.5, 1.0], [0.6, 1.2], [0.4, 0.9], [0.7, 1.1], [1, 2], [0.5, 1.0],
                              "cpu")
    whole = tsw.decision_counts(feats, params)
    parts = sum(tsw.decision_counts({k: v[:, a:b] for k, v in feats.items()}, params)
                for a, b in ((0, 123), (123, 400), (400, 500)))
    assert torch.equal(whole, parts)


@pytest.mark.parametrize("n_sections", [9, 17])
def test_k7_groups_chained_give_one_calls_bits(n_sections):
    """K7's plain loop over groups of at most K7_MAX_SECTIONS sections, each
    group's output the next one's input and the state in the cascade's
    dtype (float64 past 8 sections), gives the bits of one call over all
    sections, ``y`` and ``zf``; ``sosfilt`` carries that dtype."""
    import re

    src = (Path(tf.__file__).resolve().parent.parent / "csrc" / "filters.cu").read_text()
    assert int(re.search(r"constexpr int kMaxSections = (\d+);", src).group(1)) == \
        tf.K7_MAX_SECTIONS
    groups = tf.k7_groups(n_sections)
    assert groups[0][0] == 0 and groups[-1][1] == n_sections
    assert all(b - a <= tf.K7_MAX_SECTIONS for a, b in groups)
    sos = _wide_sos(n_sections)
    # up to 8 sections the design decides (a 3 kHz low-pass keeps float32);
    # past 8 every design takes float64
    assert tf.k7_state_dtype(tf.butter_sos(2 * tf.K7_MAX_SECTIONS, 3000.0 / (0.5 * FS),
                                           "lowpass")) == torch.float32
    assert tf.k7_state_dtype(tf.butter_sos(2 * n_sections, 3000.0 / (0.5 * FS),
                                           "lowpass")) == torch.float64
    assert tf.k7_state_dtype(sos) == torch.float64
    coef = torch.from_numpy(tf._sos_coefficients(sos))
    rng = np.random.default_rng(n_sections)
    x = torch.from_numpy((0.1 * rng.standard_normal((2, 700))).astype(np.float32))
    zi = torch.from_numpy(0.01 * rng.standard_normal((2, n_sections, 2)))
    y1, zf1 = tf.sosfilt(sos, x, zi)
    assert zf1.dtype == torch.float64
    y, zfs = x, []
    for a, b in groups:
        y, zf = tf._sosfilt_zi_plain(coef[a:b], y, zi[:, a:b])
        zfs.append(zf)
    assert torch.equal(y, y1) and torch.equal(torch.cat(zfs, dim=1), zf1)


def test_k9_k6_k4_routes():
    from audio_processing_tools_tpu_torch.ops import peaks as tpk

    assert [tpk.k9_route(n) for n in (384, 1024, 1025, 1152, 30000)] == \
        ["warp", "warp", "block", "block", "block"]
    assert tpk.k9_long_plan(1152) == (2048, True, True)
    assert tpk.k9_long_plan(30000) == (32768, False, True)
    assert tpk.k9_long_plan(600_000)[2] is False
    assert [tb.k6_route(S, W) for S, W in ((4, 30), (8, 64), (4, 100), (13, 30), (16, 128),
                                           (4, 3), (7, 4))] == \
        ["warp", "warp", "general", "general", "general", "general", "general"]
    assert [tf.k4_route(S) for S in (2, 4, 8, 9, 16, 17, 24)] == \
        ["registers"] * 5 + ["wide"] * 2


def _order_key(v: np.ndarray) -> np.ndarray:
    """``order_key`` of ``csrc/peaks.cu``: an unsigned key that grows with
    the value, -0 equal to +0, NaN below -inf."""
    v = np.where(v == 0, np.float32(0), v).astype(np.float32)
    u = v.view(np.uint32).astype(np.uint64)
    key = np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)
    return np.where(np.isnan(v), 1, key).astype(np.uint64)


def _k9_block_model(x, is_peak, distance, steps):
    """The block route's algorithm in NumPy, row by row: every position's key
    ``order_key(value) << 32 | index`` (a non-peak's value -inf) in
    descending order, the first ``steps`` keys the loop's order, then the
    walk over 32-bit words of covered positions."""
    n = x.shape[-1]
    out = np.zeros_like(is_peak)
    d = min(max(distance, 0), n)
    for r in range(x.shape[0]):
        vals = np.where(is_peak[r], x[r], np.float32(-np.inf))
        keys = (_order_key(vals) << np.uint64(32)) | np.arange(n, dtype=np.uint64)
        order = (np.sort(keys)[::-1][:steps] & np.uint64(0xFFFFFFFF)).astype(np.int64)
        words = np.zeros(-(-n // 32), np.uint64)
        for p in order:
            if not is_peak[r, p] or (words[p >> 5] >> np.uint64(p & 31)) & np.uint64(1):
                continue
            lo, hi = max(p - d + 1, 0), min(p + d - 1, n - 1)
            for w in range(lo >> 5, (hi >> 5) + 1):
                a, b = max(lo - 32 * w, 0), min(hi - 32 * w, 31)
                win = ((1 << (b + 1)) - 1) & ~((1 << a) - 1)
                if p >> 5 == w:
                    win &= ~(1 << (p & 31))
                words[w] |= np.uint64(win)
        covered = (words[np.arange(n) >> 5] >> (np.arange(n) & 31).astype(np.uint64)) & np.uint64(1)
        out[r] = is_peak[r] & (covered == 0)
    return out


@pytest.mark.parametrize("cap", [64, 5000])
def test_k9_block_route_model_matches_the_plain_loop(cap):
    """The block route's algorithm (K9 past 1,024 positions) gives the plain
    loop's mask on rows of 1,152 with ties, plateaus, -0, NaN and -inf."""
    from audio_processing_tools_tpu_torch.ops import peaks as tpk

    rng = np.random.default_rng(cap)
    n = 1152
    x = np.stack([rng.random(n), np.round(rng.random(n) * 4), np.repeat(rng.random(n), 8)[:n],
                  rng.random(n)]).astype(np.float32)
    x[3, rng.integers(0, n, 40)] = np.nan
    x[3, rng.integers(0, n, 40)] = -np.inf
    x[3, rng.integers(0, n, 40)] = -0.0
    is_peak = rng.random(x.shape) < 0.3
    steps = min(cap, n)
    got = _k9_block_model(x, is_peak, 45, steps)
    ref = tpk._select_peaks_by_distance_plain(torch.from_numpy(x), torch.from_numpy(is_peak),
                                              45, cap).numpy()
    np.testing.assert_array_equal(got, ref)


def test_band_noise_per_frame_path_takes_the_collision_form():
    """``BandNoiseEstimator`` frame by frame at W = 3, S = 4 gives the whole
    clip's bits: the per-frame path runs the same scan step."""
    from audio_processing_tools_tpu_torch.models import band_noise_streaming as tbs

    cfg = tb.BandNoiseEstimatorConfig(W=3, W_min=1)
    x = _bn_signal(5, seconds=2.0)
    x = x[: x.size // cfg.frame_len * cfg.frame_len]
    full = tb.band_noise_process(torch.from_numpy(x), cfg, device="cpu")
    frames = list(tbs.BandNoiseEstimator(cfg, device="cpu").process_stream(x))
    assert [f.noise_buffer_valid_count for f in frames] == full["noise_buffer_valid_count"].tolist()
    assert max(f.noise_buffer_valid_count for f in frames) > cfg.W
    for k in ("N_E", "G_mag", "noise_effective_q"):
        np.testing.assert_array_equal(np.float32([getattr(f, k) for f in frames]),
                                      full[k].numpy(), err_msg=k)
