"""Parameter tuning: grid search, classifier wrappers, native/device bridges.

Counterpart of ``audio_processing_tools_tpu/tuning/__init__.py``, with the
same exports: the reference ``edge/parameter_tuning/`` harness, and the
device sweeps: grids of decision thresholds are scored on features
computed once (kernel K10 on the card), and the continuous thresholds can
be fitted by Adam.
"""

from audio_processing_tools_tpu_torch.tuning.grid_search import (
    grid_search,
    grid_search_parallel,
    grid_search_vmapped,
    roe_grid_search_vmapped,
    generate_param_combinations,
    spectral_threshold_features,
)
from audio_processing_tools_tpu_torch.tuning.gradient import (
    gradient_tune_thresholds,
    roe_gradient_tune_thresholds,
)
from audio_processing_tools_tpu_torch.tuning.classification_algo import (
    python_classifier_wrapper,
    c_classifier_wrapper,
    grid_search_classification_wrapper,
)
from audio_processing_tools_tpu_torch.tuning.call_native import (
    rain_detection_algo as rain_detection_algo_native,
    get_version,
    load_native_library,
)
from audio_processing_tools_tpu_torch.tuning.profiles import (
    TUNED_ACCURACY_V1,
    apply_profile,
    available_profiles,
    get_profile,
)

__all__ = [
    "TUNED_ACCURACY_V1",
    "apply_profile",
    "available_profiles",
    "get_profile",
    "grid_search",
    "grid_search_parallel",
    "grid_search_vmapped",
    "roe_grid_search_vmapped",
    "generate_param_combinations",
    "spectral_threshold_features",
    "gradient_tune_thresholds",
    "roe_gradient_tune_thresholds",
    "python_classifier_wrapper",
    "c_classifier_wrapper",
    "grid_search_classification_wrapper",
    "rain_detection_algo_native",
    "get_version",
    "load_native_library",
]
