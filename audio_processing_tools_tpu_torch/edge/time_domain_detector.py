"""Shim: reference path ``edge/time_domain_detector.py``."""

from audio_processing_tools_tpu_torch.models.time_domain import (  # noqa: F401
    TimeDomainDetectorConfig,
    TimeDomainRainDetector,
    build_time_domain_config,
)
