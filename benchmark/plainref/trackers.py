"""Causal trackers, plain PyTorch on the CPU.

Frozen copy of the port's ``ops/trackers.py`` CPU paths: the stochastic
low-quantile baseline (the detector's flux baseline, K3's plain loop) and
the quantile noise PSD tracker (K2's plain loop), each a Python loop over
frames that mirrors the JAX package's ``lax.scan`` step operation for
operation.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def causal_low_quantile_baseline(x: torch.Tensor, *, q_percent: float, samples_per_sec: float,
                                 win_sec: float, floor: float) -> torch.Tensor:
    """Causal stochastic low-quantile baseline over the last axis
    (``trackers.py:47-79``): the baseline emitted at index ``t`` is the
    estimate before ingesting ``x[t]``."""
    q = float(np.clip(q_percent, 0.0, 100.0)) / 100.0
    floor = float(max(floor, 1e-12))
    sps = float(max(samples_per_sec, 1e-6))
    W = max(3, int(round(float(win_sec) * sps)))
    eta = float(np.clip(2.0 / max(W + 1, 2), 1e-4, 1.0))
    scale_alpha = float(np.clip(1.0 - eta, 0.0, 0.9999))
    x = x.to(torch.float32)
    baseline = torch.clamp(x[..., 0], min=floor)
    scale = torch.clamp(torch.abs(x[..., 0]), min=floor)
    outs = []
    for t in range(x.shape[-1]):
        xt = x[..., t]
        outs.append(baseline)
        err = xt - baseline
        scale = scale_alpha * scale + (1.0 - scale_alpha) * torch.abs(err)
        step_sz = eta * torch.clamp(scale, min=floor)
        delta = torch.where(xt >= baseline, q * step_sz, -(1.0 - q) * step_sz)
        baseline = torch.clamp(baseline + delta, min=floor)
    out = torch.stack(outs, dim=-1)
    out = torch.nan_to_num(out, nan=floor, posinf=floor, neginf=floor)
    return torch.clamp(out, min=floor)


class PsdTrackParams(NamedTuple):
    """Knobs of the PSD tracker (``trackers.py:85-96``)."""

    W: int
    q: float
    ema_up: float
    ema_down: float
    eps: float
    maxr: float


def make_psd_params(cfg_q: float, win_sec: float, frames_per_sec: float, ema_up: float,
                    ema_down: float, eps: float, noise_psd_max_ratio: float) -> PsdTrackParams:
    """Derive tracker constants (``trackers.py:99-117``), without the
    adaptive quantile."""
    W = max(10, int(win_sec * frames_per_sec))
    maxr = float(noise_psd_max_ratio)
    maxr = 1.0 if not np.isfinite(maxr) else float(np.clip(maxr, 0.0, 1.0))
    return PsdTrackParams(
        W=W, q=float(cfg_q), ema_up=float(ema_up), ema_down=float(ema_down),
        eps=float(eps), maxr=maxr)


def noise_psd_track(P_band: torch.Tensor, is_rain: torch.Tensor,
                    p: PsdTrackParams) -> torch.Tensor:
    """Track the noise PSD of a band block over time (``trackers.py:148-200,
    :305-369``).  ``P_band`` (..., K, T) linear power; ``is_rain`` (..., T),
    frames excluded from updates after warm-up.  Returns ``N_band``
    (..., K, T).  K2 gives its values bit for bit."""
    P_band = P_band.to(torch.float32)
    is_rain = is_rain.to(torch.bool)
    eta = float(np.clip(2.0 / max(p.W + 1, 2), 1e-4, 1.0))
    step_floor = float(max(p.eps, 1e-9))
    warmup_need = max(10, p.W // 2)
    scale_alpha = float(p.ema_down)

    first_frame = P_band[..., 0]
    lead, dev = first_frame.shape[:-1], first_frame.device
    tracker = torch.clamp(first_frame, min=0.0)
    scale = torch.clamp(torch.abs(first_frame), min=step_floor)
    prev_N = torch.zeros_like(first_frame)
    wcount = torch.zeros(lead, dtype=torch.int32, device=dev)
    is_first = torch.ones(lead, dtype=torch.bool, device=dev)
    outs = []
    for t in range(P_band.shape[-1]):
        Pt, raint = P_band[..., t], is_rain[..., t]
        allow = (wcount < warmup_need) | (~raint)
        err = Pt - tracker
        scale_new = scale_alpha * scale + (1.0 - scale_alpha) * torch.abs(err)
        step_sz = eta * torch.clamp(scale_new, min=step_floor)
        delta = torch.where(Pt >= tracker, p.q * step_sz, -(1.0 - p.q) * step_sz)
        candidate = torch.clamp(tracker + delta, min=0.0)
        # the stream's first frame keeps the initial tracker and scale
        first = is_first[..., None]
        tracker = torch.where(first | ~allow[..., None], tracker, candidate)
        scale = torch.where(first, scale, scale_new)
        lam = torch.where(tracker > prev_N, p.ema_up, p.ema_down)
        N = torch.where(first, tracker, lam * prev_N + (1.0 - lam) * tracker)
        N = torch.minimum(N, p.maxr * Pt)
        N = torch.clamp(N, min=0.0)
        wcount = wcount + allow.to(torch.int32)
        is_first = torch.zeros_like(is_first)
        prev_N = N
        outs.append(N)
    return torch.stack(outs, dim=-1)
