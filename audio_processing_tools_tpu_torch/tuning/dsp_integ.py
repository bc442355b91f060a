"""Two-pass confirm variant of the RoE classifier.

Counterpart of ``audio_processing_tools_tpu/tuning/dsp_integ.py`` (reference
``edge/parameter_tuning/dsp_integ.py:1353-1373``): analyse the first
``check_duration`` window; when the drop count is below
``ceil(min_drop_count * duration * 2)``, check the next window and require
the combined count to clear the threshold (else zero).  The algorithm body
is the port's RoE (``models/roe.py::_roe_batch`` on a one-row batch, whose
``rain_drop_count_raw`` is the count before the FP/FN combiner); only the
wrapper differs.  Runs on the card unless ``device="cpu"``.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from audio_processing_tools_tpu_torch.models.roe import RoeConfig, _roe_batch, build_roe_config

DSP_INTEG_DEFAULTS = dict(
    sample_rate=11162,
    freq_resolution=45,
    time_resolution_ms=10,
    check_duration=2,
    op_freq_range=[400, 3000],
    n_freq_range=[400, 600],
    fn=400,
    num_harmonics=6,
    harmonic_threshold=[5, 4, 4, 4, 4, 4],
    max_peaks=3,
    log_factor=10,
    ns_duration_ms=470,
    nf=0,
    min_drop_count=1,
    # two-pass raw counting: no FP/FN combiner in this wrapper
    handle_fp=False,
    handle_fn=False,
)


def _window_counts(cfg: RoeConfig, x: np.ndarray, offset_s: float,
                   device: str | torch.device) -> Tuple[int, float]:
    """Raw drop count + frain over one check window starting at offset."""
    sr = cfg.sample_rate
    start = int(sr * offset_s)
    if start >= x.size or x.size - start < sr:
        return 0, 0.0
    window = torch.as_tensor(x[start:][None], device=torch.device(device))
    out = _roe_batch(window, cfg)
    return int(out["rain_drop_count_raw"][0]), float(out["frain_mean"][0])


def analyse_raw_audio_wrapper(audio_data, device: str | torch.device = "cuda",
                              **kwargs) -> Tuple[int, float]:
    """Two-pass confirm logic (``dsp_integ.py:1353-1373``)."""
    params = {**DSP_INTEG_DEFAULTS, **kwargs}
    cfg = build_roe_config(**params)
    x = np.ascontiguousarray(np.asarray(audio_data, np.float32).reshape(-1))
    duration = cfg.check_duration

    count, frain = _window_counts(cfg, x, 0.0, device)
    threshold = math.ceil(cfg.min_drop_count * duration * 2)
    if count < threshold:
        count1, frain = _window_counts(cfg, x, duration, device)
        if count + count1 > threshold:
            count = threshold
        else:
            count = 0
    return count, frain


def rain_detection_algo(audio_data, device: str | torch.device = "cuda",
                        **kwargs) -> Tuple[int, float]:
    """(``dsp_integ.py:1342-1350``)."""
    return analyse_raw_audio_wrapper(audio_data, device=device, **kwargs)


def sample_classifier_to_evaluate(audio_data, threshold: int = 2,
                                  device: str | torch.device = "cuda", **kwargs):
    """Boolean test-vector classifier (``dsp_integ.py:1309-1340``)."""
    count, _ = analyse_raw_audio_wrapper(audio_data, device=device, **kwargs)
    if count > threshold:
        return True
    if 0 <= count <= threshold:
        return False
    return np.nan
