"""Port parity: the framework's processors (``framework/processor.py``)
against the JAX package's on one clip.  ``RainProcessor`` wraps each side's
RoE ``rain_detection_algo``; ``NoiseProcessor`` runs each side's spectral
engine.  Decisions, counts and frame classes are identical; ``frain_mean``
within 1e-6 of its value and the noise floors within 1e-5 relative (the
bounds of ``tests/test_torch_roe.py`` and ``tests/test_torch_suppressor.py``)."""

import functools

import numpy as np
import pytest

from audio_processing_tools_tpu.framework import processor as jproc
from audio_processing_tools_tpu.models.roe import rain_detection_algo as jroe_algo

from audio_processing_tools_tpu_torch import framework as tframework
from audio_processing_tools_tpu_torch.config import DEFAULT_MODE_BANDS
from audio_processing_tools_tpu_torch.framework import processor as tproc
from audio_processing_tools_tpu_torch.models.roe import rain_detection_algo as troe_algo

FS = 11162
PARAMS = {"sample_rate": FS, "check_duration": 2.0, "return_spectra": False}


@pytest.fixture(scope="module")
def clip():
    """Quiet noise with sharp damped harmonic pings."""
    rng = np.random.default_rng(4)
    n = int(FS * 2)
    x = 0.006 * rng.standard_normal(n)
    k = np.arange(800)
    ping = np.exp(-k / 50.0) * sum(a * np.sin(2 * np.pi * f * k / FS)
                                   for f, a in ((520.0, 1.0), (1040.0, 0.5), (1560.0, 0.35)))
    for t0 in rng.integers(FS // 4, n - 1000, 16):
        x[t0 : t0 + 800] += rng.uniform(0.3, 0.5) * ping
    return np.clip(x, -1.0, 1.0).astype(np.float32)


def test_rain_processor_matches_jax(clip):
    got, st = tproc.RainProcessor(name="roe", fn=functools.partial(troe_algo, device="cpu")).run(
        clip, PARAMS)
    ref, st_ref = jproc.RainProcessor(name="roe", fn=jroe_algo).run(clip, PARAMS)
    assert got.keys() == ref.keys() and st["processor"] == st_ref["processor"] == "roe"
    for key in ("rain_drops", "rain_drop_count", "rain_peaks_count", "rain_drop_count_mod"):
        assert int(got[key]) == int(ref[key]), key
    assert got["rain_drops"] > 0
    np.testing.assert_allclose(got["frain_mean"], ref["frain_mean"], rtol=1e-6)
    np.testing.assert_array_equal(st["raining"], np.asarray(st_ref["raining"]))
    with pytest.raises(ValueError, match="too short"):
        tproc.RainProcessor(name="roe", fn=troe_algo).run(clip[:100], PARAMS)


def test_noise_processor_matches_jax(clip):
    params = {"sample_rate": FS, "detector": {"mode_bands": list(DEFAULT_MODE_BANDS)}}
    got, st = tproc.NoiseProcessor(name="noise", device="cpu").run(clip, params)
    ref, st_ref = jproc.NoiseProcessor(name="noise").run(clip, params)
    assert got.keys() == ref.keys()
    assert got["rain_frame_fraction"] == ref["rain_frame_fraction"] > 0
    for key in ("mean_noise_floor_db", "median_noise_floor_db"):
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-5)
    np.testing.assert_array_equal(st["frame_class"], np.asarray(st_ref["frame_class"]))
    np.testing.assert_array_equal(st["is_rain"], st_ref["is_rain"])
    assert st.keys() == st_ref.keys()


def test_framework_exports():
    assert set(tframework.__all__) == {"AudioProcessor", "BaseProcessor", "RainProcessor",
                                       "NoiseProcessor", "has_processor",
                                       "process_audio_batches_v2", "process_audio_batches",
                                       "restore_state_df_from_parquet"}
    procs = [tproc.NoiseProcessor(name="noise"), tproc.RainProcessor(name="roe", fn=troe_algo)]
    assert tproc.has_processor(procs, "roe") and not tproc.has_processor(procs, "mel")
    assert isinstance(procs[0], tproc.AudioProcessor)
    assert procs[0].device == "cuda"  # the card unless the caller asks for the CPU
    with pytest.raises(TypeError):
        procs[0]._validate_audio([0.0], {})
