"""Shim: reference path ``edge/rain_signal_processor.py``."""

from audio_processing_tools_tpu_torch.config import (  # noqa: F401
    NoiseConfig as NoiseProcessorConfig,
    build_noise_config,
)
from audio_processing_tools_tpu_torch.models.spectral_noise import (  # noqa: F401
    SpectralNoiseEngine as SpectralNoiseProcessor,
    RainDetectorProcessor,
)
