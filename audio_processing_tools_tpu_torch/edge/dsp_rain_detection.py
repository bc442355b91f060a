"""Shim: reference path ``edge/dsp_rain_detection.py`` (legacy RoE)."""

from audio_processing_tools_tpu_torch.models.roe import (  # noqa: F401
    RoeConfig,
    build_roe_config,
    rain_detection_algo,
    python_classifier_boolean_wrapper,
    roe_detect_batch,
)
