"""Power spectrogram through the hand-written CUDA kernel K1.

Counterpart of ``audio_processing_tools_tpu/ops/spectrogram.py:155-224``,
whose Pallas kernel ``_power_kernel`` (``:77-96``) fuses framing, the Hann
window, the real DFT and the power into one pass.  Here that kernel is
``csrc/spectrogram_power.cu``, a fused shared-memory FFT; its plain version
is :func:`~audio_processing_tools_tpu_torch.ops.stft.stft_power`.

A CPU tensor takes the plain version.  A CUDA tensor launches the kernel or
raises: there is no fallback.  The kernel takes a power-of-two ``n_fft``
from 64 to 1024 and any ``hop`` that is a multiple of 4.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from audio_processing_tools_tpu_torch import _kernels
from audio_processing_tools_tpu_torch.ops._device import device_constant
from audio_processing_tools_tpu_torch.ops.stft import stft_power
from audio_processing_tools_tpu_torch.ops.windows import analysis_window

#: threads per block of the kernel
THREADS = 256
#: dynamic shared memory one block may use on Hopper
SMEM_LIMIT = 232_448
#: n_fft the kernel supports
N_FFTS = (64, 128, 256, 512, 1024)


class LaunchPlan(NamedTuple):
    frame_tile: int  # frames per work item
    smem_bytes: int  # dynamic shared memory per block


def _smem_bytes(n_fft: int, hop: int, frame_tile: int) -> int:
    """Shared memory of one block, as ``smem_bytes_for`` in the kernel's source:
    two sample slabs, one FFT exchange buffer per frame in flight, the
    (F, frame_tile) power tile."""
    M = n_fft // 2
    G = M // 8  # threads per frame
    frames_in_flight = THREADS // G
    slab = (frame_tile - 1) * hop + n_fft
    tile_stride = (frame_tile + 31) // 32 * 32 + (32 // G if G < 32 else 1)
    return 4 * 2 * slab + 8 * frames_in_flight * (M + 8) + 4 * (M + 1) * tile_stride


def launch_plan(n_fft: int, hop: int) -> LaunchPlan:
    """The kernel's frame tile and shared memory for this geometry.

    The tile is the largest power of two up to 32 frames (32 was the fastest
    at the main shape on an H100) whose block fits in :data:`SMEM_LIMIT`;
    one frame always fits.  Raises ``ValueError`` for a geometry the kernel
    does not take.
    """
    if n_fft not in N_FFTS:
        raise ValueError(f"the CUDA spectrogram kernel needs n_fft in {N_FFTS}; got {n_fft}")
    if hop < 4 or hop % 4:
        raise ValueError(f"the CUDA spectrogram kernel needs hop a positive multiple of 4; got {hop}")
    ft = 32
    while ft > 1 and _smem_bytes(n_fft, hop, ft) > SMEM_LIMIT:
        ft //= 2
    return LaunchPlan(ft, _smem_bytes(n_fft, hop, ft))


def kernel_tables(n_fft: int, window: str = "hann"):
    """The kernel's host tables, built in float64 and rounded to float32:
    the window (n_fft,), the periodic Hann window or ones for ``"rect"``,
    and the twiddles ``e^{-2 pi i k / n_fft}``, k < n_fft, as (n_fft, 2)
    (re, im) pairs."""
    ang = -2.0 * np.pi * np.arange(n_fft, dtype=np.float64) / n_fft
    twiddle = np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32)
    return analysis_window(window, n_fft), twiddle


def spectrogram_power(x: torch.Tensor, n_fft: int = 256, hop: int = 128,
                      center: bool = True, window: str = "hann") -> torch.Tensor:
    """``|STFT|^2`` of the last axis as ``(..., 1 + n_fft//2, T)`` float32.

    Centered framing pads ``n_fft // 2`` zeros on both sides (librosa's
    ``pad_mode="constant"``).  ``window`` is ``"hann"`` (periodic) or
    ``"rect"`` (no window: the kernel multiplies by ones, which is exact).
    Matches :func:`stft_power` to float32 rounding.
    """
    if x.device.type == "cpu":
        return stft_power(x, n_fft=n_fft, hop=hop, center=center, window=window)
    analysis_window(window, 1)  # an unknown window raises here, before the launch
    plan = launch_plan(n_fft, hop)
    x = x.to(torch.float32).contiguous()
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
    win, twiddle = device_constant(("spectrogram_tables", n_fft, window), x.device,
                                   lambda: kernel_tables(n_fft, window))
    lib = _kernels.build()
    with torch.cuda.device(x.device):
        err = lib.lib.apt_spectrogram_power(
            xb.data_ptr(), win.data_ptr(), twiddle.data_ptr(), out.data_ptr(),
            xb.shape[0], n, T, n_fft, hop, pad, plan.frame_tile, plan.smem_bytes,
            _kernels.stream_of(xb),
        )
    lib.check(err, "spectrogram_power")
    _kernels.count("spectrogram_power")
    return out.reshape(lead + (F, T))
