"""Power spectrogram through the hand-written CUDA kernel K1.

Counterpart of ``audio_processing_tools_tpu/ops/spectrogram.py:155-224``,
whose Pallas kernel ``_power_kernel`` (``:77-96``) fuses framing, the Hann
window, the real DFT and the power into one pass.  Here that kernel is
``csrc/spectrogram_power.cu``, a fused shared-memory FFT; its plain version
is :func:`~audio_processing_tools_tpu_torch.ops.stft.stft_power`.

A CPU tensor takes the plain version.  A CUDA tensor launches the kernel or
raises: there is no fallback.  The kernel has three routes, picked from the
geometry alone by :func:`k1_route`: the FFT for a power-of-two ``n_fft``
from 64 to 1024 with a ``hop`` that is a multiple of 4 (the main path's
256/128); the mixed-radix FFT (``csrc/mixed_fft.cuh``) for every even
``n_fft`` whose half has no odd prime factor above :data:`MIXED_MAX_PRIME`,
at any ``hop`` (the TPU kernel's own sizes ``128 m``, ``m <= 32``, among
them); and the direct DFT (the TPU kernel's window-and-DFT product) for
every other ``n_fft >= 1`` and ``hop >= 1`` up to :data:`DFT_MAX_N_FFT`.
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


#: the largest n_fft of the DFT route: one frame's samples in shared memory,
#: the last plan of ``dft_plan_for`` in the kernel's source
DFT_MAX_N_FFT = SMEM_LIMIT // 4


#: the largest odd prime factor of n_fft / 2 the mixed route takes
#: (``kMaxPrime`` of ``csrc/mixed_fft.cuh``)
MIXED_MAX_PRIME = 31
#: frames a block of the mixed route holds at most (``kMixedMaxTile``)
MIXED_MAX_TILE = 32


def mixed_radices(M: int):
    """The passes of the mixed route's M-point transform, in order
    (``mixed_plan_of`` in ``csrc/mixed_fft.cuh``): radix 8 while 8 divides
    the power of two, then one radix 4 or 2, then the odd primes ascending;
    ``None`` where ``M < 2`` or an odd prime factor passes
    :data:`MIXED_MAX_PRIME`."""
    if M < 2:
        return None
    radices, q = [], M
    while q % 8 == 0:
        radices.append(8)
        q //= 8
    if q % 4 == 0:
        radices.append(4)
        q //= 4
    elif q % 2 == 0:
        radices.append(2)
        q //= 2
    for f in range(3, MIXED_MAX_PRIME + 1, 2):
        while q % f == 0:
            radices.append(f)
            q //= f
    return tuple(radices) if q == 1 else None


def tile_elems(rows: int, frame_tile: int) -> int:
    """float2 of one tile buffer (``tile_elems``): ``rows`` points of the
    tile's frames at row stride ``frame_tile + 1``, rounded up to even."""
    return (rows * (frame_tile + 1) + 1) // 2 * 2


def _mixed_smem(n_fft: int, frame_tile: int) -> int:
    """Shared memory of one block of the mixed route, as ``mixed_smem_for``
    in the kernel's source: two tile buffers of n_fft / 2 points (the
    samples are staged in the second)."""
    return 16 * tile_elems(n_fft // 2, frame_tile)


def mixed_launch_plan(n_fft: int) -> LaunchPlan:
    """The mixed route's frame tile and shared memory: the largest power of
    two up to :data:`MIXED_MAX_TILE` frames whose block takes at most a
    quarter of :data:`SMEM_LIMIT` (four blocks an SM), else one frame up to
    the whole limit: the fastest tile at 384, 400, 640, 768 and 2,048 on an
    H100 80GB HBM3 at 700 W (``tools/time_mixed_tiles.py``; at 384/192 and
    128 x 10 s, 0.1280 ms with 16 frames a block against 0.1740 with 32).
    Raises ``ValueError`` where even one frame does not fit."""
    for ft in (32, 16, 8, 4, 2, 1):
        if _mixed_smem(n_fft, ft) <= SMEM_LIMIT // 4:
            return LaunchPlan(ft, _mixed_smem(n_fft, ft))
    if _mixed_smem(n_fft, 1) <= SMEM_LIMIT:
        return LaunchPlan(1, _mixed_smem(n_fft, 1))
    raise ValueError(f"the mixed route's frame of n_fft {n_fft} does not fit shared memory")


def mixed_route_takes(n_fft: int) -> bool:
    """Whether the mixed FFT takes an ``n_fft`` (any hop): even, at least 4,
    its half with a plan (:func:`mixed_radices`) and one frame's block in
    :data:`SMEM_LIMIT`."""
    return (n_fft >= 4 and n_fft % 2 == 0 and mixed_radices(n_fft // 2) is not None
            and _mixed_smem(n_fft, 1) <= SMEM_LIMIT)


def k1_route(n_fft: int, hop: int) -> str:
    """K1's route for a geometry: ``"fft"`` (the power-of-two shared-memory
    FFT, whose plan is :func:`launch_plan`), ``"mixed"`` (the mixed-radix
    FFT, :func:`mixed_launch_plan`) or ``"dft"`` (the direct DFT, whose plan
    the kernel's source picks: ``dft_plan_for``).
    Raises ``ValueError`` where none takes it: ``n_fft`` or ``hop`` below
    1, or ``n_fft`` above :data:`DFT_MAX_N_FFT`."""
    if n_fft < 1 or hop < 1:
        raise ValueError(f"spectrogram_power needs n_fft >= 1 and hop >= 1; got {n_fft}, {hop}")
    if n_fft in N_FFTS and hop % 4 == 0:
        return "fft"
    if mixed_route_takes(n_fft):
        return "mixed"
    if n_fft > DFT_MAX_N_FFT:
        raise ValueError(f"the CUDA spectrogram kernel takes n_fft up to {DFT_MAX_N_FFT}; "
                         f"got {n_fft}")
    return "dft"


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
    return _spectrogram_power_cuda(x, n_fft, hop, center, window, k1_route(n_fft, hop))


def _spectrogram_power_cuda(x: torch.Tensor, n_fft: int, hop: int, center: bool, window: str,
                            route: str) -> torch.Tensor:
    """K1 on the card through ``route``: :func:`k1_route`'s for the
    geometry, or ``"dft"`` (which takes every geometry) and ``"mixed"``
    (every size with a plan) for comparisons.  Raises where the route does
    not take the geometry."""
    analysis_window(window, 1)  # an unknown window raises here, before the launch
    if route not in ("fft", "mixed", "dft"):
        raise ValueError(f"spectrogram_power: no route {route!r}")
    if route == "mixed" and not mixed_route_takes(n_fft):
        raise ValueError(f"the mixed route does not take n_fft {n_fft}")
    if route == "dft" and not 1 <= n_fft <= DFT_MAX_N_FFT:
        raise ValueError(f"the DFT route does not take n_fft {n_fft}")
    plan = (launch_plan(n_fft, hop) if route == "fft"
            else mixed_launch_plan(n_fft) if route == "mixed" else None)
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
    args = (xb.data_ptr(), win.data_ptr(), twiddle.data_ptr(), out.data_ptr(), xb.shape[0], n, T,
            n_fft, hop, pad)
    with torch.cuda.device(x.device):
        if route == "dft":
            err = lib.lib.apt_spectrogram_power_dft(*args, _kernels.stream_of(xb))
        else:
            launch = (lib.lib.apt_spectrogram_power if route == "fft"
                      else lib.lib.apt_spectrogram_power_mixed)
            err = launch(*args, plan.frame_tile, plan.smem_bytes, _kernels.stream_of(xb))
    lib.check(err, "spectrogram_power")
    _kernels.count("spectrogram_power")
    return out.reshape(lead + (F, T))
