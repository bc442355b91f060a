"""Config variants of the ported classifier-only engine against the JAX
engine: detector debug and feature dump, TD soft labels, winsorized and
weighted flux, ratio-dB normalization with adaptive q, causal smoothing of
the noise PSD, a band-pass prefilter, spectra and filtered audio, the peak
gate, the comb-filter and band-pass TD front ends, TD envelope features,
clip spectral occupancy with the clip-summary tier, and the sparse feature
dump in its "first" and "top" selections."""

import numpy as np
import pytest
import torch

from audio_processing_tools_tpu.config import DEFAULT_MODE_BANDS
from audio_processing_tools_tpu.config import build_noise_config as jbuild
from audio_processing_tools_tpu.models.spectral_noise import SpectralNoiseEngine as JEngine
from audio_processing_tools_tpu.utils.corpus import make_labeled_corpus

from audio_processing_tools_tpu_torch.config import build_noise_config
from audio_processing_tools_tpu_torch.models.spectral_noise import SpectralNoiseEngine

FS = 11162
DET = {"mode_bands": list(DEFAULT_MODE_BANDS)}

VARIANTS = {
    "debug_and_dump": {"return_detector_debug": True, "dump_features": True,
                       "detector": {**DET, "feature_dump_level": 1,
                                    "feature_dump_include_td_soft": True}},
    "td_soft_kurt_gate": {"detector": {**DET, "td_soft_enable": True,
                                       "td_kurtosis_upper_threshold": 40.0}},
    "winsor_weights": {"detector": {**DET, "flux_modes_winsor_enable": True,
                                    "mode_weights": [1.0, 0.8, 0.6, 0.4, 0.2]}},
    "ratio_db_adaptive_q": {"detector_noise_norm_mode": "ratio_db",
                            "adaptive_q_enable": True, "noise_psd_max_ratio": 0.8,
                            "detector": DET},
    "smoothed_psd": {"pre_smooth_frames": 3, "median_frames": 4, "detector": DET},
    "bandpass_no_norm": {"pre_filter_mode": "bandpass", "detector_use_noise_norm": False,
                         "detector": DET},
    "spectra_and_audio": {"return_spectra": True, "return_filtered_audio": True,
                          "detector": DET},
    "peak_gate": {"return_detector_debug": True,
                  "detector": {**DET, "peak_features_enable": True}},
    "td_comb_filter": {"return_detector_debug": True,
                       "detector": {**DET, "td_input_mode": "comb_filter"}},
    "td_bandpass": {"return_detector_debug": True,
                    "detector": {**DET, "td_input_mode": "bandpass",
                                 "td_input_band": [500.0, 3000.0]}},
    "td_envelope": {"return_detector_debug": True,
                    "detector": {**DET, "td_envelope_features_enable": True}},
    "occupancy_clip_summary": {"return_detector_debug": True, "dump_features": True,
                               "detector": {**DET, "clip_spectral_occupancy_enable": True,
                                            "feature_dump_level": 1,
                                            "feature_dump_clip_summary_enable": True}},
    "sparse_dump_first": {"dump_features": True,
                          "detector": {**DET, "feature_dump_level": 1,
                                       "feature_dump_sparse_enable": True,
                                       "feature_dump_sparse_max_frames": 8}},
    "sparse_dump_top": {"dump_features": True,
                        "detector": {**DET, "feature_dump_level": 1,
                                     "feature_dump_sparse_enable": True,
                                     "feature_dump_sparse_select": "top",
                                     "feature_dump_sparse_gate_feature": "td_crest_factor",
                                     "feature_dump_sparse_gate_threshold": 3.0,
                                     "feature_dump_include_raw_spectral_basic": True}},
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


def _compare(got, ref, path=""):
    if isinstance(ref, dict):
        assert set(got) == set(ref), (path, set(got) ^ set(ref))
        for k in ref:
            _compare(got[k], ref[k], f"{path}/{k}")
        return
    if not isinstance(got, torch.Tensor):
        # a Python constant of the port; the vmapped JAX program repeats it per clip
        assert np.all(np.asarray(ref) == got), path
        return
    g = got.numpy()
    r = np.asarray(ref)
    assert g.shape == r.shape, path
    if r.dtype.kind in "biu" or path.endswith(("frame_class", "rain_conf", "noise_conf")):
        np.testing.assert_array_equal(g, r, err_msg=path)
    elif r.dtype.kind == "c":
        assert _rel(g.real, r.real) <= 1e-5 and _rel(g.imag, r.imag) <= 1e-5, path
    else:
        assert _rel(g, r) <= _bound(path), (path, _rel(g, r))


def _bound(path):
    """1e-4 for the TD features (the JAX package's own bound) and for what
    lies downstream of the log of the power spectrogram (mode flux in dB,
    cepstrum): the two engines' spectrograms agree to ~1e-7 of their maximum,
    and the log turns that into a larger relative change at low-power bins.
    1e-5 for everything else."""
    return 1e-4 if any(s in path for s in ("/td_", "flux", "cepstrum")) else 1e-5


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_variant_matches_jax_engine(clips, variant):
    params = {"classifier_only_mode": True, **VARIANTS[variant]}
    ref = JEngine(jbuild(FS, params)).process_batch(clips)
    got = SpectralNoiseEngine(build_noise_config(FS, params), device="cpu").process_batch(clips)
    _compare(got, ref)
