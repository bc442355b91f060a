"""Port parity: the native RoE bridge (``tuning/call_native.py`` over the
port's own ``native/roe_classifier.cpp``, built by g++ at first use), the
boolean wrappers, the two-pass ``dsp_integ`` wrapper and the device-in-loop
backend, against the JAX package's ``tuning/`` on the CPU.

Tolerances: boolean decisions of the port's RoE, the JAX RoE and the native
library identical on every clip; the port's drop counts equal to JAX's and
within max(3, 20%) of the native float64 ones (``tests/test_native.py:78-91``)
and ``frain_mean`` within 1e-6 of JAX's (``tests/test_torch_roe.py``'s bound);
``dsp_integ`` counts identical to JAX's and ``frain`` within 1e-6 of JAX's
(RoE's ``frain_mean``: a long float32 sum, whose order XLA fixes by its own
rules; observed 3 float32 ulps on the 30-drop clip, as the sharded RoE of
``tests/test_torch_parallel.py``); the device-backend response bytes
round-trip exactly.
"""

import ctypes
import importlib

import numpy as np
import pytest

from audio_processing_tools_tpu.tuning import classification_algo as jca
from audio_processing_tools_tpu.utils.corpus import make_labeled_corpus

from audio_processing_tools_tpu_torch.tuning import call_native as tcn
from audio_processing_tools_tpu_torch.tuning import classification_algo as tca
from audio_processing_tools_tpu_torch.tuning import device_backend as tdb

jdi = importlib.import_module("audio_processing_tools_tpu.tuning.dsp_integ")
tdi = importlib.import_module("audio_processing_tools_tpu_torch.tuning.dsp_integ")

FS = 11162
PARAMS = dict(sample_rate=FS, check_duration=10, op_freq_range=[400, 3500],
              n_freq_range=[400, 700], harmonic_threshold=[4.5, 4.0, 3.5, 3.5, 3.5, 3.5],
              min_drop_count=0.3)


@pytest.fixture(scope="module")
def lib():
    return tcn.load_native_library()


def _harmonic_rain(rng, seconds=10, fn=500.0, drops=80):
    n = FS * seconds
    x = 0.003 * rng.standard_normal(n)
    for t0 in rng.integers(0, n - 1200, drops):
        k = np.arange(1000)
        ping = sum((1.0 / h) * np.sin(2 * np.pi * fn * h * k / FS) for h in range(1, 6))
        x[t0 : t0 + 1000] += 0.6 * np.exp(-k / 80.0) * ping
    return x.astype(np.float32)


def _clips():
    """The clips of ``tests/test_native.py:66-71`` and the corpus classes of
    ``:127-130`` (2 s checks), with their labels and parameters."""
    rng = np.random.default_rng(1234)
    cases = [
        ("rain_heavy", _harmonic_rain(rng, drops=100), True, PARAMS),
        ("rain_light", _harmonic_rain(rng, drops=40), True, PARAMS),
        ("noise", (0.02 * rng.standard_normal(FS * 10)).astype(np.float32), False, PARAMS),
        ("quiet", (0.002 * rng.standard_normal(FS * 10)).astype(np.float32), False, PARAMS),
    ]
    clips, labels, kinds = make_labeled_corpus(seed=21, seconds=2.0,
                                               counts={"noise": 2, "wind": 3, "tonal": 3})
    short = {**PARAMS, "check_duration": 2}
    cases += [(f"{k}_{i}", x, bool(lab), short)
              for i, (x, lab, k) in enumerate(zip(clips, labels, kinds))]
    return cases


CASES = _clips()


def test_build_and_version(lib):
    """The port's g++ build of its own source, and its version string."""
    path = tcn.build_native_library()
    assert "apt_torch_native" in path and path.endswith(tcn.NATIVE_LIB)
    v = tcn.get_version(lib)
    assert "tpu-native-roe" in v and "audio_processing_tools_tpu_torch" in v


def test_missing_compiler_names_gpp(monkeypatch, tmp_path):
    from audio_processing_tools_tpu_torch.io import alac_native

    monkeypatch.setattr(alac_native, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(alac_native, "_BUILD_ERRORS", {})
    monkeypatch.setattr(alac_native.shutil, "which", lambda name: None)
    monkeypatch.delenv("DSP_NATIVE_LIB", raising=False)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        tcn.load_native_library()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_port_jax_and_native_agree(lib, case):
    """The boolean wrappers: the port's RoE on the CPU, the JAX RoE and the
    native library give the label on every clip
    (``tests/test_native.py:58-75, 113-136``)."""
    _, x, label, params = case
    port = tca.python_classifier_wrapper(x, device="cpu", **params)
    jax_ = jca.python_classifier_wrapper(x, **params)
    native = tca.c_classifier_wrapper(x, lib=lib, **params)
    assert port == jax_ == native == label


def test_counts_match_jax_and_native(lib):
    """``tests/test_native.py:78-91``: the port's counts are JAX's; the
    native float64 ones are close."""
    from audio_processing_tools_tpu.models.roe import rain_detection_algo as jalgo
    from audio_processing_tools_tpu_torch.models.roe import rain_detection_algo as talgo

    x = _harmonic_rain(np.random.default_rng(1234), drops=80)
    drops_t, frain_t, _ = talgo(x, device="cpu", **PARAMS)
    drops_j, frain_j, _ = jalgo(x, **PARAMS)
    drops_c, frain_c = tcn.rain_detection_algo(x, lib=lib, **PARAMS)
    assert drops_t == drops_j > 0
    assert abs(frain_t - frain_j) <= 1e-6 * abs(frain_j)  # tests/test_torch_roe.py's bound
    assert abs(drops_t - drops_c) <= max(3, 0.2 * drops_t), (drops_t, drops_c)
    assert abs(frain_t - frain_c) < 30, (frain_t, frain_c)


def test_native_bad_input(lib):
    inp = tcn.evmgr_data_input_t()
    inp.audio_len = 0
    out = tcn.rain_cl_optional_data_t()
    cfg = tcn.rain_cl_config_param_t()
    r = lib.sample_classifier_to_evaluate_impl(ctypes.byref(inp), ctypes.byref(out),
                                               ctypes.byref(cfg))
    assert r == -1
    from audio_processing_tools_tpu.tuning import call_native as jcn

    for name in ("evmgr_sensor_data_t", "evmgr_data_input_t", "rain_cl_optional_data_t",
                 "rain_cl_config_param_t"):
        assert ctypes.sizeof(getattr(tcn, name)) == ctypes.sizeof(getattr(jcn, name)), name
    assert tcn.DEFAULT_PARAMS == jcn.DEFAULT_PARAMS
    assert tcn.twos_complement_hex(-2) == jcn.twos_complement_hex(-2) == 0xFFFE


def test_dsp_integ_matches_jax():
    """The two-pass confirm wrapper on 3 clips: counts identical, ``frain``
    within 1e-6 of JAX's."""
    rng = np.random.default_rng(7)
    clips = [_harmonic_rain(rng, seconds=5, drops=30), _harmonic_rain(rng, seconds=5, drops=4),
             (0.01 * rng.standard_normal(FS * 5)).astype(np.float32)]
    for x in clips:
        ct, ft = tdi.rain_detection_algo(x, device="cpu")
        cj, fj = jdi.rain_detection_algo(x)
        assert ct == cj, (ct, cj)
        assert abs(ft - fj) <= 1e-6 * abs(fj), (ft, fj)
        assert tdi.sample_classifier_to_evaluate(x, device="cpu") == \
            jdi.sample_classifier_to_evaluate(x)


@pytest.mark.parametrize("case", ["round trip", "short response", "missing m3cli"])
def test_device_backend(case):
    if case == "missing m3cli":
        with pytest.raises(tdb.DeviceBackendError, match="m3cli"):
            tdb.rain_detection_algo_device(np.zeros(100, np.float32),
                                           m3cli_path="/nonexistent/m3cli")
        return
    resp = tdb.rain_cl_optional_data_t()
    resp.raindrops = 42
    resp.mean_freq[0] = 512.5
    raw = bytes(resp) if case == "round trip" else bytes(resp)[:10]
    calls = []

    def runner(cmd, data):
        calls.append((cmd, data))
        return raw

    x = (0.5 * np.sin(np.arange(FS) / 10.0)).astype(np.float32)
    if case == "short response":
        with pytest.raises(tdb.DeviceBackendError, match="too short"):
            tdb.rain_detection_algo_device(x, runner=runner)
        return
    assert tdb.rain_detection_algo_device(x, runner=runner, flash_model=True) == (42, 512.5)
    assert [c[0][1] for c in calls] == ["dfu_model", "model_input", "cm7ctl"]
    pcm = np.frombuffer(calls[1][1], "<i2")
    np.testing.assert_array_equal(pcm, (np.clip(x, -1, 1) * 32767.0).astype(np.int16))
