"""Shim: reference path ``edge/band_noise_processor.py``."""

from audio_processing_tools_tpu_torch.models.band_noise import (  # noqa: F401
    BandNoiseEstimatorProcessor,
    build_band_noise_config,
)
