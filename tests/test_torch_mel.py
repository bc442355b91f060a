"""Port parity: the mel features (``ops/mel.py``; kernel K1 runs its plain
version on the CPU) and the mel rain classifier
(``models/mel_classifier.py``) against the JAX package's modules, which run
here on the XLA ``rfft`` path.

Tolerances against JAX: the scale conversions and the filterbank (float64
NumPy) identical; ``mel_spectrogram`` and ``band_energies`` within 1e-5 of
their maximum (two FFT libraries, two matrix-product orders); the
classifier's ``clip_is_rain`` and ``frame_is_rain`` identical,
``clip_score_db`` within 1e-4 absolute (dB), the other float outputs within
1e-4 of their maximum; the processor's ``run`` and ``run_batch`` give the
same decisions as JAX's and as each other.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_processing_tools_tpu.models import mel_classifier as jmc
from audio_processing_tools_tpu.ops import mel as jmel

from audio_processing_tools_tpu_torch.models import mel_classifier as tmc
from audio_processing_tools_tpu_torch.ops import mel as tmel
from audio_processing_tools_tpu_torch.ops.stft import fft_frequencies, stft_power

FS = 11162


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _clips(seed, n_clips=4, seconds=4.0):
    """Noise clips and clips of quieter noise with sharp damped 900 Hz pings
    (alternating)."""
    rng = np.random.default_rng(seed)
    n = int(FS * seconds)
    k = np.arange(600)
    ping = np.exp(-k / 40.0) * np.sin(2 * np.pi * 900.0 * k / FS)
    out = np.empty((n_clips, n), np.float32)
    for i in range(n_clips):
        x = (0.02 if i % 2 == 0 else 0.005) * rng.standard_normal(n)
        if i % 2:
            for t0 in rng.integers(FS // 4, n - 800, int(6 * seconds)):
                x[t0 : t0 + 600] += rng.uniform(0.3, 0.6) * ping
        out[i] = x
    return out


@pytest.fixture(scope="module")
def clips():
    return _clips(11)


def test_scales_and_filterbank_identical():
    f = np.array([0.0, 200.0, 999.0, 1000.0, 2000.0, 5581.0])
    for htk in (False, True):
        np.testing.assert_array_equal(tmel.hz_to_mel(f, htk), jmel.hz_to_mel(f, htk))
        m = jmel.hz_to_mel(f, htk)
        np.testing.assert_array_equal(tmel.mel_to_hz(m, htk), jmel.mel_to_hz(m, htk))
        assert tmel.hz_to_mel(1500.0, htk) == jmel.hz_to_mel(1500.0, htk)
        assert tmel.mel_to_hz(20.0, htk) == jmel.mel_to_hz(20.0, htk)
    for args in ((FS, 256, 40), (FS, 512, 24, 100.0, 4000.0), (FS, 256, 32, 0.0, None, True)):
        np.testing.assert_array_equal(tmel.mel_filterbank(*args), jmel.mel_filterbank(*args))
    np.testing.assert_array_equal(tmel.mel_filterbank(FS, 256, 40, norm=None),
                                  jmel.mel_filterbank(FS, 256, 40, norm=None))
    with pytest.raises(ValueError, match="norm"):
        tmel.mel_filterbank(FS, 256, 40, norm="bogus")


@pytest.mark.parametrize("log", [False, True])
def test_mel_spectrogram_matches_jax(clips, log):
    got = tmel.mel_spectrogram(torch.from_numpy(clips), sr=FS, n_mels=40, log=log).numpy()
    ref = np.asarray(jmel.mel_spectrogram(jnp.asarray(clips), sr=FS, n_mels=40, log=log))
    assert got.shape == ref.shape == (clips.shape[0], 40, 1 + clips.shape[1] // 128)
    assert _rel(got, ref) <= 1e-5


def test_band_energies_matches_jax(clips):
    freqs = fft_frequencies(FS, 256)
    P = stft_power(torch.from_numpy(clips))
    bands = [(450.0, 650.0), (800.0, 1050.0), (1500.0, 1800.0)]
    for db in (False, True):
        got = tmel.band_energies(P, freqs, bands, db=db).numpy()
        ref = np.asarray(jmel.band_energies(jnp.asarray(P.numpy()), freqs, bands, db=db))
        assert got.shape == ref.shape == (clips.shape[0], 3, P.shape[-1])
        assert _rel(got, ref) <= 1e-5


@pytest.mark.parametrize("params", [
    {},
    {"n_mels": 32, "mel": {"band_lo_hz": 600.0, "clip_quantile": 0.9}},
    {"sample_rate": FS, "frame_flux_db": 4.0, "mel": {"frame_flux_db": 9.0}},
])
def test_config_matches_jax(params):
    got, ref = tmc.build_mel_config(params), jmc.build_mel_config(params)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    np.testing.assert_array_equal(tmc.MelRainClassifier(got, device="cpu")._band_mask(),
                                  jmc.MelRainClassifier(ref)._band_mask())


def test_config_validation():
    for bad in ({"clip_quantile": 0.0}, {"band_hi_hz": 100.0}, {"n_mels": 3}):
        with pytest.raises(ValueError):
            tmc.build_mel_config(bad)


def test_classifier_matches_jax(clips):
    got = tmc.MelRainClassifier(device="cpu").process_batch(clips, sr=FS)
    ref = jmc.MelRainClassifier().process_batch(clips, sr=FS)
    assert set(got) == set(ref)
    np.testing.assert_array_equal(got["clip_is_rain"].numpy(), np.asarray(ref["clip_is_rain"]))
    np.testing.assert_array_equal(got["frame_is_rain"].numpy(), np.asarray(ref["frame_is_rain"]))
    np.testing.assert_allclose(got["clip_score_db"].numpy(), np.asarray(ref["clip_score_db"]),
                               rtol=0, atol=1e-4)
    for key in ("band_energy_db", "mel_flux_db", "rain_frame_fraction"):
        assert _rel(got[key].numpy(), np.asarray(ref[key])) <= 1e-4, key
    # the corpus separates: ping clips rain, noise clips do not
    np.testing.assert_array_equal(got["clip_is_rain"].numpy(), np.arange(clips.shape[0]) % 2 == 1)


def test_processor_run_and_run_batch_match_jax(clips):
    params = {"sample_rate": FS}
    proc = tmc.MelRainProcessor(device="cpu")
    pairs = proc.run_batch(clips, params)
    jpairs = jmc.MelRainProcessor().run_batch(clips, params)
    assert len(pairs) == len(jpairs) == clips.shape[0]
    for i, ((m, s), (jm, js)) in enumerate(zip(pairs, jpairs)):
        assert set(m) == set(jm) and set(s) == set(js)
        assert m["clip_is_rain"] == jm["clip_is_rain"]
        assert m["rain_frame_fraction"] == pytest.approx(jm["rain_frame_fraction"], abs=1e-6)
        np.testing.assert_array_equal(s["frame_is_rain"], js["frame_is_rain"])
        one, _ = proc.run(clips[i], params)
        jone, _ = jmc.MelRainProcessor().run(clips[i], params)
        assert one["clip_is_rain"] == m["clip_is_rain"] == jone["clip_is_rain"]
        assert one["clip_score_db"] == m["clip_score_db"]  # a clip alone = in a batch
    with pytest.raises(ValueError, match="1-D"):
        proc.run(clips, params)
    with pytest.raises(ValueError, match="2-D"):
        proc.run_batch(clips[0], params)
