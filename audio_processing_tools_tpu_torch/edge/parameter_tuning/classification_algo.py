"""Shim: reference path ``edge/parameter_tuning/classification_algo.py``."""

from audio_processing_tools_tpu_torch.tuning.classification_algo import (  # noqa: F401
    python_classifier_wrapper as python_classifier_boolean_wrapper,
    c_classifier_wrapper as c_classifier_boolean_wrapper,
    grid_search_classification_wrapper,
)
