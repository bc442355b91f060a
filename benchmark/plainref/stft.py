"""The power spectrogram with librosa-parity framing, batched over leading axes.

Counterpart of ``audio_processing_tools_tpu/ops/stft.py:36-148`` and
``ops/windows.py:8-26``: the periodic Hann window, ``n_fft // 2`` zeros
padded on both sides (centred, ``pad_mode="constant"``), ``T = 1 + n // hop``
frames, output ``(..., F, T)`` with ``F = 1 + n_fft // 2``.
:func:`stft_power` is the plain version of the hand-written spectrogram
kernel K1 (``ops/spectrogram.py``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as tnf

from .consts import host
from .framing import frame_signal


def fft_frequencies(sr: float, n_fft: int) -> np.ndarray:
    """Bin center frequencies; matches ``librosa.fft_frequencies``."""
    return np.linspace(0.0, float(sr) / 2.0, 1 + n_fft // 2, dtype=np.float64)


def hann_window(n: int) -> np.ndarray:
    """The periodic Hann window, float32:
    ``scipy.signal.get_window("hann", n, fftbins=True)``."""
    k = np.arange(n, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * k / n)).astype(np.float32)


def stft_power(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """``|STFT|^2`` of the last axis, centred, as float32 ``(..., F, T)``,
    contiguous."""
    x = tnf.pad(x.to(torch.float32), (n_fft // 2, n_fft // 2))
    frames = frame_signal(x, n_fft, hop) * host(lambda: hann_window(n_fft))  # (..., T, n_fft)
    s = torch.fft.rfft(frames, dim=-1).transpose(-1, -2)
    return (s.real * s.real + s.imag * s.imag).contiguous()
