"""EAC pitch estimation and instantaneous frequency, batched.

Counterpart of ``audio_processing_tools_tpu/models/pitch.py``: per-frame
autocorrelation as an FFT correlation, the harmonic-summation lag search
as a masked argmax, and the Hilbert instantaneous frequency.  The JAX
package runs these through ``jnp.fft`` (no Pallas kernel); here they are
``torch.fft`` calls on ``device``.  ``torch`` has no ``unwrap``, so
:func:`unwrap` writes NumPy's (``discont = pi``, ``period = 2 pi``), its
running sum of corrections in the order of JAX's compiled ``cumsum``: the
unwrapped phase grows to hundreds of radians, where a float32 ulp is 3e-5,
and the instantaneous frequency differences it.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from audio_processing_tools_tpu_torch.ops._device import f32
from audio_processing_tools_tpu_torch.ops.trackers import _cumsum_xla_order


def _frames(x, device) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(x, np.float32) if not torch.is_tensor(x) else x)
    return t.to(device=torch.device(device), dtype=torch.float32)


def compute_eac_for_frames(audio_frames, center_clip_threshold: float = 0.3,
                           device: str | torch.device = "cuda") -> torch.Tensor:
    """Per-frame autocorrelation at non-negative lags, normalized by its
    largest magnitude (``pitch.py:21-37``).  The reference's centre clipping
    is disabled in its own code, so ``center_clip_threshold`` is unused."""
    frames = _frames(audio_frames, device)
    n = frames.shape[-1]
    # full autocorrelation via rFFT with zero padding to >= 2n-1
    nfft = 1 << int(np.ceil(np.log2(2 * n - 1)))
    F = torch.fft.rfft(frames, n=nfft, dim=-1)
    ac = torch.fft.irfft(F * torch.conj(F), n=nfft, dim=-1)[..., :n]
    peak = torch.amax(torch.abs(ac), dim=-1, keepdim=True)
    return torch.where(peak > 0, ac / peak, ac)


def estimate_pitch_from_eac(eac_matrix, fs: int, fmin: float = 50, fmax: float = 1000,
                            harmonic_weights: Tuple[float, ...] = (1.0, 0.5, 0.25),
                            device: str | torch.device = "cuda") -> torch.Tensor:
    """Harmonic-summation pitch per frame (``pitch.py:40-63``): the lag in
    ``[fs / fmax, fs / fmin)`` maximizing the weighted sum of the EAC at its
    multiples; ``fs / lag`` as float32."""
    eac = _frames(eac_matrix, device)
    dev = eac.device
    n = eac.shape[-1]
    lag_min = int(fs / fmax)
    lag_max = min(int(fs / fmin), n)
    if lag_max <= lag_min:
        return torch.zeros(eac.shape[:-1], dtype=torch.float32, device=dev)

    lags = np.arange(lag_min, lag_max)
    score = torch.zeros(eac.shape[:-1] + (lags.size,), dtype=torch.float32, device=dev)
    for h, w in enumerate(harmonic_weights, start=1):
        h_lag = lags * h
        valid = h_lag < n
        contrib = torch.where(torch.as_tensor(valid, device=dev),
                              eac[..., torch.as_tensor(np.where(valid, h_lag, 0), device=dev)], 0.0)
        score = score + f32(w, dev) * contrib
    best_lag = torch.as_tensor(lags, device=dev)[torch.argmax(score, dim=-1)]
    return torch.where(best_lag > 0, f32(fs, dev) / best_lag.to(torch.float32), 0.0)


def unwrap(p: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``np.unwrap(p, axis=dim)``: jumps over ``pi`` between neighbours
    become their ``2 pi``-wrapped value, corrections summed along ``dim`` in
    the JAX package's ``cumsum`` order."""
    p = p.movedim(dim, -1)
    pi = f32(math.pi, p.device)
    dd = torch.diff(p, dim=-1)
    ddmod = torch.remainder(dd + pi, 2 * pi) - pi
    ddmod = torch.where((ddmod == -pi) & (dd > 0), pi, ddmod)
    ph_correct = torch.where(torch.abs(dd) < pi, 0.0, ddmod - dd)
    up = torch.cat([p[..., :1], p[..., 1:] + _cumsum_xla_order(ph_correct)], dim=-1)
    return up.movedim(-1, dim)


def compute_instantaneous_frequency(frame, fs: float,
                                    device: str | torch.device = "cuda") -> np.ndarray:
    """Hilbert instantaneous frequency in Hz (``pitch.py:66-82``), the last
    value repeated to keep the frame's length."""
    frame = _frames(frame, device)
    n = frame.shape[-1]
    X = torch.fft.fft(frame, dim=-1)
    h = np.zeros(n)
    if n % 2 == 0:
        h[0] = h[n // 2] = 1.0
        h[1 : n // 2] = 2.0
    else:
        h[0] = 1.0
        h[1 : (n + 1) // 2] = 2.0
    analytic = torch.fft.ifft(X * torch.as_tensor(h, dtype=torch.float32, device=frame.device),
                              dim=-1)
    dphi = torch.diff(unwrap(torch.angle(analytic)), dim=-1)
    f_inst = f32(fs / (2.0 * math.pi), frame.device) * dphi
    return torch.cat([f_inst, f_inst[..., -1:]], dim=-1).cpu().numpy()
