"""Power spectrogram through the hand-written CUDA kernel K1.

Counterpart of ``audio_processing_tools_tpu/ops/spectrogram.py:155-224``,
whose Pallas kernel ``_power_kernel`` (``:77-96``) fuses framing, the Hann
window, the real DFT and the power into one pass.  Here that kernel is
``csrc/spectrogram_power.cu``; its plain version is
:func:`~audio_processing_tools_tpu_torch.ops.stft.stft_power`.

A CPU tensor takes the plain version.  A CUDA tensor launches the kernel or
raises: there is no fallback.
"""

from __future__ import annotations

import numpy as np
import torch

from audio_processing_tools_tpu_torch import _kernels
from audio_processing_tools_tpu_torch.ops._device import device_constant
from audio_processing_tools_tpu_torch.ops.stft import stft_power
from audio_processing_tools_tpu_torch.ops.windows import hann_window


def _rbins_pad(n_fft: int) -> int:
    """rFFT bin count padded to a multiple of 8 (the TPU kernel's layout)."""
    return (1 + n_fft // 2 + 7) // 8 * 8


def _dft_matrix_t(n_fft: int) -> np.ndarray:
    """(2*FP, n_fft) window+DFT matrix, rFFT bins only (``:57-74``).

    Row ``r < F`` is ``w * cos`` of bin ``r``; row ``FP + r`` is ``w * sin``
    of bin ``r``.  Built in float64 on the host, cast to float32.
    """
    FP = _rbins_pad(n_fft)
    F = 1 + n_fft // 2
    r = np.arange(F)[:, None].astype(np.float64)
    k = np.arange(n_fft)[None, :].astype(np.float64)
    ang = -2.0 * np.pi * r * k / n_fft
    w = hann_window(n_fft, dtype=np.float64)[None, :]
    out = np.zeros((2 * FP, n_fft))
    out[:F] = w * np.cos(ang)
    out[FP : FP + F] = w * np.sin(ang)
    return out.astype(np.float32)


def _dft_rows(n_fft: int, device: torch.device):
    """The kernel's (F, n_fft) cos and sin rows, resident on ``device``."""
    F = 1 + n_fft // 2
    FP = _rbins_pad(n_fft)

    def make():
        W = _dft_matrix_t(n_fft)
        return (np.ascontiguousarray(W[:F]), np.ascontiguousarray(W[FP : FP + F]))

    return device_constant(("dft_rows", n_fft), device, make)


def spectrogram_power(x: torch.Tensor, n_fft: int = 256, hop: int = 128,
                      center: bool = True) -> torch.Tensor:
    """``|STFT|^2`` of the last axis as ``(..., 1 + n_fft//2, T)`` float32.

    Centered framing pads ``n_fft // 2`` zeros on both sides (librosa's
    ``pad_mode="constant"``).  Matches :func:`stft_power` to float32
    rounding.
    """
    if x.device.type == "cpu":
        return stft_power(x, n_fft=n_fft, hop=hop, center=center)
    if n_fft % 4 or hop % 4:
        raise ValueError(
            f"the CUDA spectrogram kernel needs n_fft and hop divisible by 4; "
            f"got n_fft={n_fft}, hop={hop}"
        )
    lead = x.shape[:-1]
    n = x.shape[-1]
    xb = x.reshape(-1, n)
    _kernels.require_cuda("spectrogram_power", xb, torch.float32, 2)
    pad = n_fft // 2 if center else 0
    T = 1 + (n + 2 * pad - n_fft) // hop if n + 2 * pad >= n_fft else 0
    F = 1 + n_fft // 2
    out = torch.empty((xb.shape[0], F, T), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out.reshape(lead + (F, T))
    wcos, wsin = _dft_rows(n_fft, x.device)
    lib = _kernels.build()
    with torch.cuda.device(x.device):
        err = lib.lib.apt_spectrogram_power(
            xb.data_ptr(), wcos.data_ptr(), wsin.data_ptr(), out.data_ptr(),
            xb.shape[0], n, F, T, n_fft, hop, pad, _kernels.stream_of(xb),
        )
    lib.check(err, "spectrogram_power")
    _kernels.count("spectrogram_power")
    return out.reshape(lead + (F, T))
