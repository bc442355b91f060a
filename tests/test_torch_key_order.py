"""Port parity: the engines' output dicts list their keys in JAX's order.

JAX's ``jit`` returns a dict with its keys sorted, at every level; the
port's engines return theirs the same way, so tables built from them
(``viz.frames_to_df``, DataFrames of a batch) have JAX's columns in JAX's
order.  Each case runs the JAX engine and the port's on the CPU on one
short clip and compares the nested key lists (values are compared by each
engine's own parity tests).
"""

import numpy as np
import pytest
import torch

from audio_processing_tools_tpu.config import DEFAULT_MODE_BANDS
from audio_processing_tools_tpu.models import band_noise as jbn
from audio_processing_tools_tpu.models import roe as jroe
from audio_processing_tools_tpu.models.spectral_noise import SpectralNoiseEngine as JaxEngine
from audio_processing_tools_tpu.models.streaming import StreamingRainDetector as JaxDetector

from audio_processing_tools_tpu_torch.models import band_noise as tbn
from audio_processing_tools_tpu_torch.models import roe as troe
from audio_processing_tools_tpu_torch.models.spectral_noise import SpectralNoiseEngine
from audio_processing_tools_tpu_torch.models.streaming import StreamingRainDetector

FS = 11162
BASE = {"sample_rate": FS, "detector": {"mode_bands": list(DEFAULT_MODE_BANDS)}}
ENGINE_CONFIGS = {
    "classifier only": {"classifier_only_mode": True},
    "default": {},
    "every output": {"return_debug": True, "return_detector_debug": True,
                     "return_noise_psd": True, "compute_output_audio": True,
                     "return_spectra": True, "return_filtered_audio": True},
}
STREAM_CONFIGS = {"detector": {}, "audio out": {"compute_output_audio": True}}


def key_lists(tree, path=""):
    """``[(path, keys)]`` for the dict ``tree`` and every dict inside it."""
    out = [(path, list(tree))]
    for k, v in tree.items():
        if isinstance(v, dict):
            out += key_lists(v, f"{path}{k}.")
    return out


@pytest.fixture(scope="module")
def clip():
    return (0.02 * np.random.default_rng(3).standard_normal(FS * 2)).astype(np.float32)


@pytest.mark.parametrize("name", list(ENGINE_CONFIGS))
def test_spectral_engine_keys_in_jax_order(clip, name):
    params = {**BASE, **ENGINE_CONFIGS[name]}
    jax_eng, eng = JaxEngine(), SpectralNoiseEngine(device="cpu")
    jax_eng.setup(dict(params))
    eng.setup(dict(params))
    ref = key_lists(jax_eng.process(clip))
    assert key_lists(eng.process(clip)) == ref
    batch = np.stack([clip, clip[::-1].copy()])
    ref_b = key_lists(jax_eng.process_batch(batch))
    assert key_lists(eng.process_batch(torch.from_numpy(batch))) == ref_b
    if name == "every output":
        assert {p for p, _ in ref} == {"", "debug.", "det_debug."}


@pytest.mark.parametrize("name", list(STREAM_CONFIGS))
def test_streaming_chunk_keys_in_jax_order(clip, name):
    params = {**BASE, **STREAM_CONFIGS[name]}
    jdet, det = JaxDetector(), StreamingRainDetector(device="cpu")
    jdet.setup(dict(params))
    det.setup(dict(params))
    x = np.stack([clip[:4096], clip[4096:8192]])
    jstate, jout = jdet.process_chunk_batch(jdet.init_state_batch(2), x)
    state, out = det.process_chunk_batch(det.init_state_batch(2), torch.from_numpy(x))
    assert list(out) == list(jout)
    assert list(state) == list(jstate)
    state, out = det.process_chunk(det.init_state(), clip[:4096])
    assert list(out) == list(jout) and list(state) == list(jstate)


def test_band_noise_keys_in_jax_order(clip):
    jcfg, cfg = jbn.BandNoiseEstimatorConfig(), tbn.build_band_noise_config({"sample_rate": FS})
    ref = jbn.band_noise_process(clip, jcfg)
    assert list(tbn.band_noise_process(clip, cfg, device="cpu")) == list(ref)
    jout, jstate = jbn.band_noise_process_chunk(clip[: 512 * 8], jcfg,
                                                jbn.band_noise_init_state(jcfg))
    out, state = tbn.band_noise_process_chunk(torch.from_numpy(clip[None, : 512 * 8]), cfg,
                                              tbn.band_noise_init_state(cfg, 1, "cpu"))
    assert list(out) == list(jout)
    assert key_lists(state) == key_lists(jstate)


def test_roe_batch_keys_in_jax_order(clip):
    clips = np.stack([clip, clip[::-1].copy()])
    ref = jroe.roe_detect_batch(clips)
    assert list(troe.roe_detect_batch(clips, device="cpu")) == list(ref)
