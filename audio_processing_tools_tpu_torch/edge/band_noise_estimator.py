"""Shim: reference path ``edge/band_noise_estimator.py``."""

from audio_processing_tools_tpu_torch.models.band_noise import (  # noqa: F401
    NoiseFrameDetectorConfig,
    BandNoiseEstimatorConfig,
    band_noise_process,
    hz_to_bin,
    db_to_ratio,
)
from audio_processing_tools_tpu_torch.models.band_noise_streaming import (  # noqa: F401
    BandNoiseEstimator,
    BandNoiseFrameOut,
    BandNoiseEnergyStats,
    NoiseFrameDetector,
)
