"""Shim: reference path ``edge/rain_frame_classifier.py``."""

from audio_processing_tools_tpu_torch.models.frame_classifier import (  # noqa: F401
    FrameClass,
    detect_rain_over_time,
    rain_frame_decision,
    assign_td_soft_label,
    RainFrameClassifierMixin,
)
from audio_processing_tools_tpu_torch.ops.features_spec import (  # noqa: F401
    resolve_np_dtype,
)
from audio_processing_tools_tpu_torch.ops.trackers import (  # noqa: F401
    causal_low_quantile_baseline as causal_stochastic_low_quantile_baseline,
)
