"""The ported slice as a whole against the JAX engine: classifier-only
``SpectralNoiseEngine`` and ``RainDetectorProcessor`` on the labeled corpus,
config hand-over, MARK parsing, the configurations outside the slice, and
import hygiene."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_processing_tools_tpu.config import DEFAULT_MODE_BANDS
from audio_processing_tools_tpu.config import build_noise_config as jbuild
from audio_processing_tools_tpu.io import mark as jmark
from audio_processing_tools_tpu.models.spectral_noise import (
    RainDetectorProcessor as JProcessor,
    SpectralNoiseEngine as JEngine,
)
from audio_processing_tools_tpu.utils.corpus import make_labeled_corpus

from audio_processing_tools_tpu_torch.config import (
    NoiseConfig,
    build_noise_config,
    from_jax_config,
)
from audio_processing_tools_tpu_torch.io import mark as tmark
from audio_processing_tools_tpu_torch.models.spectral_noise import (
    RainDetectorProcessor,
    SpectralNoiseEngine,
)

REPO = Path(__file__).resolve().parent.parent
FS = 11162
PARAMS = {
    "sample_rate": FS,
    "clip_rain_min_frames": 3,
    "detector": {"mode_bands": list(DEFAULT_MODE_BANDS)},
    "classifier_only_mode": True,
}


@pytest.fixture(scope="module")
def corpus():
    clips, labels, _ = make_labeled_corpus(seed=7, seconds=2.0)
    return clips, labels


def test_process_batch_matches_jax_engine_exactly(corpus):
    clips, _ = corpus
    ref = JEngine(jbuild(FS, PARAMS)).process_batch(clips)
    got = SpectralNoiseEngine(build_noise_config(FS, PARAMS), device="cpu").process_batch(clips)
    for key in ("frame_class", "rain_conf", "noise_conf", "times"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]), err_msg=key)
    assert got["frame_class"].dtype == torch.int8


def test_run_batch_clip_aggregates_identical(corpus):
    clips, labels = corpus
    ref = JProcessor().run_batch(clips, PARAMS)
    got = RainDetectorProcessor(device="cpu").run_batch(clips, PARAMS)
    assert len(got) == len(ref) == len(clips)
    for (gm, gs), (rm, rs) in zip(got, ref):
        gm.pop("latency_s"), rm.pop("latency_s")
        assert gm == rm
        np.testing.assert_array_equal(gs["frame_class"], rs["frame_class"])
    # the corpus is the accuracy canary's: every clip decided right
    assert [m["clip_is_rain"] for m, _ in got] == list(labels)


def test_run_single_clip_matches_jax(corpus):
    clips, _ = corpus
    for i in (0, 12):
        (gm, gs), (rm, rs) = (RainDetectorProcessor(device="cpu").run(clips[i], PARAMS),
                              JProcessor().run(clips[i], PARAMS))
        gm.pop("latency_s"), rm.pop("latency_s")
        assert gm == rm
        for key in ("frame_class", "rain_conf", "noise_conf", "times"):
            np.testing.assert_array_equal(gs[key], rs[key])


def test_from_jax_config_reproduces_every_field():
    params = {**PARAMS, "q": 0.3, "operating_band": [420, 3400], "gain_freq_kernel": [1, 2, 1],
              "suppressor": {"ema_up": 0.5}, "detector": {**PARAMS["detector"], "noise_hi": 0.7}}
    jcfg = jbuild(FS, params)
    cfg = from_jax_config(dataclasses.asdict(jcfg))
    assert isinstance(cfg, NoiseConfig)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(build_noise_config(FS, params)) == dataclasses.asdict(jcfg)
    assert [f.name for f in dataclasses.fields(cfg)] == [f.name for f in dataclasses.fields(jcfg)]
    assert cfg.cache_key() == jcfg.cache_key()
    with pytest.raises(ValueError, match="unknown"):
        from_jax_config({**dataclasses.asdict(jcfg), "not_a_field": 1})


def test_mark_bytes_from_jax_writer_parse_bit_equal():
    rng = np.random.default_rng(11)
    pcm = (rng.standard_normal(5001) * 3000).astype(np.int16)
    kw = dict(sample_rate=FS, timestamp=1700000123, device_id="DEV00042", lat=1.5,
              lon=-2.25, alt=3.0)
    for endianness in (0, 1):
        data = jmark.write_mark_audio_file(pcm, endianness=endianness, **kw)
        assert tmark.write_mark_audio_file(pcm, endianness=endianness, **kw) == data
        sig, meta = tmark.parse_mark_audio_file(data)
        ref_sig, ref_meta = jmark.parse_mark_audio_file(data)
        np.testing.assert_array_equal(sig, ref_sig)
        assert sig.dtype == np.int16 and meta == ref_meta
        assert tmark.parse_mark_header(data) == jmark.parse_mark_header(data)
    fl = np.linspace(-1.2, 1.2, 999).astype(np.float32)
    assert tmark.write_mark_audio_file(fl) == jmark.write_mark_audio_file(fl)
    raw = pcm.tobytes() + b"\x01"  # no header, odd byte: raw-PCM defaults
    sig, meta = tmark.parse_mark_audio_file(raw)
    ref_sig, ref_meta = jmark.parse_mark_audio_file(raw)
    np.testing.assert_array_equal(sig, ref_sig)
    assert meta == ref_meta


_OUT_OF_SLICE = {
    "suppressor": ({"classifier_only_mode": False}, "P10"),
    "peak_gate": ({"detector": {"peak_features_enable": True}}, "P9"),
    "td_input_mode": ({"detector": {"td_input_mode": "comb_filter"}}, "P9"),
    "td_envelope": ({"detector": {"td_envelope_features_enable": True}}, "P9"),
    "clip_occupancy": ({"detector": {"clip_spectral_occupancy_enable": True}}, "P9"),
    "sparse_dump": ({"dump_features": True, "detector": {
        "feature_dump_level": 1, "feature_dump_sparse_enable": True}}, "P9"),
}


@pytest.mark.parametrize("case", sorted(_OUT_OF_SLICE))
def test_configs_outside_the_slice_raise(case):
    extra, item = _OUT_OF_SLICE[case]
    params = {**PARAMS, **extra,
              "detector": {**PARAMS["detector"], **extra.get("detector", {})}}
    eng = SpectralNoiseEngine(build_noise_config(FS, params), device="cpu")
    with pytest.raises(NotImplementedError, match=item):
        eng.process_batch(np.zeros((1, 3000), np.float32))


def test_alac_payload_raises_not_implemented():
    data = jmark.write_mark_audio_file(np.zeros(10, np.int16), file_version=1,
                                       payload=b"\x00" * 16)
    with pytest.raises(NotImplementedError, match="P21"):
        tmark.parse_mark_audio_file(data)
    with pytest.raises(NotImplementedError, match="P21"):
        tmark.write_mark_audio_file(np.zeros(10, np.int16), file_version=1)


def test_port_imports_no_jax():
    probe = (
        "import pkgutil, importlib, sys\n"
        "import audio_processing_tools_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert len(names) >= 15, names\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'audio_processing_tools_tpu.')) or m == 'audio_processing_tools_tpu')\n"
        "assert not bad, bad\n"
        "print('NO_JAX', len(names))\n"
    )
    r = subprocess.run([sys.executable, "-c", probe], cwd=str(REPO),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "NO_JAX" in r.stdout


def test_detect_rain_over_time_matches_jax(corpus):
    from audio_processing_tools_tpu.models.frame_classifier import (
        detect_rain_over_time as jdetect,
    )
    from audio_processing_tools_tpu_torch.models.frame_classifier import detect_rain_over_time

    clips, _ = corpus
    rng = np.random.default_rng(12)
    x = clips[0]
    T = 1 + x.shape[-1] // 128
    P = (rng.gamma(1.0, 1.0, (129, T)) ** 2).astype(np.float32)
    P_det = (10 * np.log10(P + 1e-9) + rng.normal(0, 3, (129, T))).astype(np.float32)
    cfg = build_noise_config(FS, PARAMS)
    fc, rc, dbg, dump = detect_rain_over_time(
        cfg, torch.from_numpy(P_det)[None], torch.from_numpy(x)[None], torch.from_numpy(P)[None])
    jfc, jrc, jdbg, jdump = jdetect(jbuild(FS, PARAMS), jnp.asarray(P_det), jnp.asarray(x),
                                    raw_power=jnp.asarray(P))
    np.testing.assert_array_equal(fc[0].numpy(), np.asarray(jfc))
    np.testing.assert_array_equal(rc[0].numpy(), np.asarray(jrc))
    assert set(dbg) == set(jdbg) and dump == jdump == {}
    for key in ("noise_conf", "td_gate_mask", "td_crest_factor", "mode_flux_score"):
        np.testing.assert_allclose(dbg[key][0].numpy(), np.asarray(jdbg[key]), rtol=1e-5)
