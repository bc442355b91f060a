"""Window functions (``audio_processing_tools_tpu/ops/windows.py:8-26``)."""

from __future__ import annotations

import numpy as np


def hann_window(n: int, periodic: bool = True, dtype=np.float32) -> np.ndarray:
    """Hann window; ``periodic=True`` matches
    ``scipy.signal.get_window("hann", n, fftbins=True)``.

    Returned as a NumPy array: a window is a host constant that callers move
    to the device of the tensor they apply it to.
    """
    if n <= 0:
        raise ValueError(f"window length must be positive, got {n}")
    if n == 1:
        return np.ones(1, dtype=dtype)
    denom = n if periodic else (n - 1)
    k = np.arange(n, dtype=np.float64)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * k / denom)
    return w.astype(dtype)


#: the windows the spectrogram takes: the periodic Hann window, and the
#: rectangular one (no window) of the band-noise estimator's per-frame rFFT
WINDOWS = ("hann", "rect")


def analysis_window(name: str, n: int) -> np.ndarray:
    """The float32 analysis window ``name`` (one of :data:`WINDOWS`) of
    length ``n``."""
    if name == "hann":
        return hann_window(n)
    if name == "rect":
        return np.ones(n, np.float32)
    raise ValueError(f"unknown window {name!r}; expected one of {WINDOWS}")
