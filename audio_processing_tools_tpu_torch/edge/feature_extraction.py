"""Shim: reference path ``edge/feature_extraction.py``."""

from audio_processing_tools_tpu_torch.ops.features_td import (  # noqa: F401
    TD_CORE_FEATURE_NAMES,
    TD_ENVELOPE_FEATURE_NAMES,
    TD_FEATURE_NAMES,
    extract_td_features as extract_td_features_inline,
)
from audio_processing_tools_tpu_torch.ops.features_spec import (  # noqa: F401
    RAW_SPECTRAL_FEATURE_NAMES,
    resolve_np_dtype,
    extract_raw_spectral_features as extract_raw_spectral_shape_features_inline,
    clip_spectral_occupancy as compute_clip_spectral_occupancy_stats,
    default_spectral_occupancy_bands,
)
