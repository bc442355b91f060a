"""Boolean classifier wrappers + the labeled-corpus grid-search harness.

Counterpart of ``audio_processing_tools_tpu/tuning/classification_algo.py``
(reference ``edge/parameter_tuning/classification_algo.py``): the same
boolean wrappers over the port's RoE classifier (on the card unless
``device="cpu"``) and over the native C++ one, so a sweep can run either
side and compare: the differential-testing seam of the framework.
"""

from __future__ import annotations

from typing import Any, List, Tuple

import numpy as np
import torch

from audio_processing_tools_tpu_torch.io.mark import parse_mark_audio_file
from audio_processing_tools_tpu_torch.models.roe import (
    rain_detection_algo as python_rain_detection_algo,
)
from audio_processing_tools_tpu_torch.tuning.call_native import (
    rain_detection_algo as native_rain_detection_algo,
)


def python_classifier_wrapper(audio_signal: np.ndarray, device: str | torch.device = "cuda",
                              **kwargs):
    """True/False/NaN from the port's RoE classifier on ``device``."""
    rain_drop_count, _frain, _state = python_rain_detection_algo(
        audio_signal, device=device, **kwargs
    )
    if rain_drop_count > 0:
        return True
    if rain_drop_count == 0:
        return False
    return np.nan


def c_classifier_wrapper(audio_signal: np.ndarray, **kwargs):
    """True/False/NaN from the native C++ classifier."""
    rain_drop_count, _frain = native_rain_detection_algo(audio_signal, **kwargs)
    if rain_drop_count > 0:
        return True
    if rain_drop_count == 0:
        return False
    return np.nan


def grid_search_classification_wrapper(
    audio_df, local_audio_file_cache, boolean_algo, **params: Any
) -> Tuple[float, List[int], List[int], List[int], List[int]]:
    """Labeled-corpus accuracy harness (``classification_algo.py:65-155``).

    ``audio_df`` (a pandas DataFrame) needs columns ``source_file``,
    ``raining``, ``segment_start_seconds``, ``segment_end_seconds`` and a uid
    index.  Returns ``(accuracy, tp_uids, tn_uids, fp_uids, fn_uids)``.
    """
    import pandas as pd

    from audio_processing_tools_tpu_torch.io.fetch import get_device_raw_audio_data

    cols = ["source_file", "raining", "segment_start_seconds",
            "segment_end_seconds"]
    data = audio_df[cols].copy()

    results = {}
    for uid, row in data.iterrows():
        key = row["source_file"]
        audio_map = get_device_raw_audio_data(
            keys=[key], local_cache_location=local_audio_file_cache,
            header_only=False, verbose=False, show_progress=False,
        )
        sig, metadata = parse_mark_audio_file(audio_map[key])
        sr = metadata["sample_rate"]
        seg = sig[int(row["segment_start_seconds"] * sr)
                  : int(row["segment_end_seconds"] * sr)]
        results[uid] = boolean_algo(seg, **params)

    data["classification_output"] = pd.Series(results)

    tp = data[(data["classification_output"] == True) & (data["raining"] == True)].index.to_list()  # noqa: E712
    tn = data[(data["classification_output"] == False) & (data["raining"] == False)].index.to_list()  # noqa: E712
    fp = data[(data["classification_output"] == True) & (data["raining"] == False)].index.to_list()  # noqa: E712
    fn = data[(data["classification_output"] == False) & (data["raining"] == True)].index.to_list()  # noqa: E712
    accuracy = 1 - ((len(fn) + len(fp)) / len(data))
    return accuracy, tp, tn, fp, fn
