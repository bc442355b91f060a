"""STFT with librosa-parity semantics, batched over leading axes.

Counterpart of ``audio_processing_tools_tpu/ops/stft.py:36-88``:

  * periodic Hann window,
  * ``center=True`` pads ``n_fft // 2`` zeros on both sides
    (``pad_mode="constant"``, ``:46-53``),
  * ``T = 1 + n // hop`` frames when centered,
  * output layout ``(..., F, T)`` with ``F = 1 + n_fft // 2``.

:func:`stft_power` is the plain version of the hand-written spectrogram
kernel (``ops/spectrogram.py``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as tnf

from audio_processing_tools_tpu_torch.ops.framing import frame_signal
from audio_processing_tools_tpu_torch.ops.windows import hann_window


def fft_frequencies(sr: float, n_fft: int) -> np.ndarray:
    """Bin center frequencies; matches ``librosa.fft_frequencies``."""
    return np.linspace(0.0, float(sr) / 2.0, 1 + n_fft // 2, dtype=np.float64)


def frames_to_time(frames: np.ndarray, sr: float, hop: int) -> np.ndarray:
    """Frame index -> seconds; matches ``librosa.frames_to_time``."""
    return np.asarray(frames, dtype=np.float64) * (float(hop) / float(sr))


def _pad_center(x: torch.Tensor, n_fft: int, pad_mode: str) -> torch.Tensor:
    if pad_mode != "constant":
        raise ValueError(f"unsupported pad_mode {pad_mode!r}")
    pad = n_fft // 2
    return tnf.pad(x, (pad, pad))


def stft(x: torch.Tensor, n_fft: int = 256, hop: int = 128,
         center: bool = True, pad_mode: str = "constant") -> torch.Tensor:
    """Complex STFT of the last axis: ``(..., 1 + n_fft//2, T)``."""
    x = x.to(torch.float32)
    if center:
        x = _pad_center(x, n_fft, pad_mode)
    frames = frame_signal(x, n_fft, hop)  # (..., T, n_fft)
    w = torch.as_tensor(hann_window(n_fft), device=x.device)
    spec = torch.fft.rfft(frames * w, dim=-1)  # (..., T, F)
    return spec.transpose(-1, -2)


def stft_power(x: torch.Tensor, n_fft: int = 256, hop: int = 128,
               center: bool = True, pad_mode: str = "constant") -> torch.Tensor:
    """``|STFT|^2`` as float32 ``(..., F, T)``, contiguous."""
    s = stft(x, n_fft=n_fft, hop=hop, center=center, pad_mode=pad_mode)
    return (s.real * s.real + s.imag * s.imag).contiguous()
