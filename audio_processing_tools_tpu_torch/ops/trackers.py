"""Causal noise trackers: the detector's two per-frame recurrences.

Counterpart of ``audio_processing_tools_tpu/ops/trackers.py``:

  * :func:`causal_low_quantile_baseline` (``:30-82``), the stochastic
    low-quantile tracker that emits each value *before* ingesting it, runs
    on a CUDA tensor as the hand-written kernel K3
    (``csrc/trackers.cu``);
  * :func:`noise_psd_track` (``:121-201``), the quantile PSD tracker with
    asymmetric EMA, warm-up gating, rain exclusion, adaptive q and the
    ``N <= maxr * P`` clamp, runs on a CUDA tensor as kernel K2;
  * :func:`causal_time_mean` / :func:`causal_time_median` (``:204-248``),
    plain tensor code.

The JAX package runs the recurrences as ``lax.scan``.  Their plain
versions here are Python loops over frames that mirror the scan steps
operation for operation, including which constants are rounded to float32
in double precision and which are computed in float32; the kernels mirror
the loops the same way, so the two give the same bits.  A CPU tensor takes
the plain loop; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as tnf

from audio_processing_tools_tpu_torch import _kernels


# ---------------------------------------------------------------------------
# K3: causal low-quantile baseline
# ---------------------------------------------------------------------------


class _BaselineConsts(NamedTuple):
    q: float
    eta: float
    scale_alpha: float
    floor: float
    min_hist: int


def _baseline_consts(q_percent, samples_per_sec, win_sec, min_hist_sec,
                     floor) -> _BaselineConsts:
    """Tracker constants exactly as ``trackers.py:47-53`` derives them."""
    q = float(np.clip(q_percent, 0.0, 100.0)) / 100.0
    floor = float(max(floor, 1e-12))
    sps = float(max(samples_per_sec, 1e-6))
    W = max(3, int(round(float(win_sec) * sps)))
    eta = float(np.clip(2.0 / max(W + 1, 2), 1e-4, 1.0))
    min_hist = max(1, int(round(float(min_hist_sec) * sps)))
    scale_alpha = float(np.clip(1.0 - eta, 0.0, 0.9999))
    return _BaselineConsts(q, eta, scale_alpha, floor, min_hist)


def _baseline_plain(x: torch.Tensor, c: _BaselineConsts) -> torch.Tensor:
    """The scan of ``trackers.py:65-73`` as a loop, plus the ``:77-79``
    epilogue."""
    T = x.shape[-1]
    x0 = x[..., 0]
    baseline = torch.clamp(x0, min=c.floor)
    scale = torch.clamp(torch.abs(x0), min=c.floor)
    outs = []
    for t in range(T):
        xt = x[..., t]
        outs.append(baseline)
        err = xt - baseline
        scale = c.scale_alpha * scale + (1.0 - c.scale_alpha) * torch.abs(err)
        step_sz = c.eta * torch.clamp(scale, min=c.floor)
        delta = torch.where(xt >= baseline, c.q * step_sz, -(1.0 - c.q) * step_sz)
        baseline = torch.clamp(baseline + delta, min=c.floor)
    out = torch.stack(outs, dim=-1)
    out = torch.nan_to_num(out, nan=c.floor, posinf=c.floor, neginf=c.floor)
    return torch.clamp(out, min=c.floor)


def _baseline_cuda(x: torch.Tensor, c: _BaselineConsts) -> torch.Tensor:
    T = x.shape[-1]
    rows = x.reshape(-1, T)
    _kernels.require_cuda("causal_low_quantile_baseline", rows, torch.float32, 2)
    out = torch.empty_like(rows)
    lib = _kernels.build()
    with torch.cuda.device(x.device):
        err = lib.lib.apt_causal_low_quantile_baseline(
            rows.data_ptr(), out.data_ptr(), rows.shape[0], T,
            c.q, -(1.0 - c.q), c.eta, c.scale_alpha, 1.0 - c.scale_alpha,
            c.floor, _kernels.stream_of(rows),
        )
    lib.check(err, "causal_low_quantile_baseline")
    _kernels.count("causal_low_quantile_baseline")
    return out.reshape(x.shape)


def causal_low_quantile_baseline(
    x: torch.Tensor,
    *,
    q_percent: float,
    samples_per_sec: float,
    win_sec: float,
    min_hist_sec: float = 0.0,
    floor: float = 1e-6,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal stochastic low-quantile baseline over the last axis.

    The baseline emitted at index ``t`` is the estimate before ingesting
    ``x[t]``.  Returns ``(baseline, warm_ok)`` with the input's shape.
    """
    c = _baseline_consts(q_percent, samples_per_sec, win_sec, min_hist_sec, floor)
    x = x.to(torch.float32)
    T = x.shape[-1]
    if T == 0:
        return x, torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    if x.device.type == "cpu":
        baseline = _baseline_plain(x, c)
    else:
        baseline = _baseline_cuda(x.contiguous(), c)
    warm = torch.arange(T, device=x.device) >= c.min_hist
    return baseline, warm.expand(x.shape)


# ---------------------------------------------------------------------------
# K2: noise PSD tracker
# ---------------------------------------------------------------------------


class PsdTrackParams(NamedTuple):
    """Knobs of the PSD tracker (``trackers.py:85-96``)."""

    W: int
    q: float
    ema_up: float
    ema_down: float
    eps: float
    maxr: float
    adaptive_q_enable: bool
    adaptive_q_min: float
    adaptive_q_alpha: float


def make_psd_params(cfg_q: float, win_sec: float, frames_per_sec: float,
                    ema_up: float, ema_down: float, eps: float,
                    noise_psd_max_ratio: float = 1.0,
                    adaptive_q_enable: bool = False,
                    adaptive_q_min: float = 0.10,
                    adaptive_q_alpha: float = 0.95) -> PsdTrackParams:
    """Derive tracker constants (``trackers.py:99-117``)."""
    W = max(10, int(win_sec * frames_per_sec))
    maxr = float(noise_psd_max_ratio)
    maxr = 1.0 if not np.isfinite(maxr) else float(np.clip(maxr, 0.0, 1.0))
    aq_base = float(cfg_q)
    aq_min = float(np.clip(adaptive_q_min, 1e-4, aq_base))
    aq_alpha = float(np.clip(adaptive_q_alpha, 0.0, 1.0))
    return PsdTrackParams(
        W=W, q=float(cfg_q), ema_up=float(ema_up), ema_down=float(ema_down),
        eps=float(eps), maxr=maxr, adaptive_q_enable=bool(adaptive_q_enable),
        adaptive_q_min=aq_min, adaptive_q_alpha=aq_alpha,
    )


def _psd_derived(p: PsdTrackParams):
    eta = float(np.clip(2.0 / max(p.W + 1, 2), 1e-4, 1.0))
    step_floor = float(max(p.eps, 1e-9))
    warmup_need = max(10, p.W // 2)
    return eta, step_floor, warmup_need


def _noise_psd_track_plain(P_band: torch.Tensor, is_rain: torch.Tensor,
                           p: PsdTrackParams) -> torch.Tensor:
    """The scan step of ``trackers.py:160-196`` as a loop over frames."""
    eta, step_floor, warmup_need = _psd_derived(p)
    scale_alpha = float(p.ema_down)
    T = P_band.shape[-1]
    first = P_band[..., 0]
    tracker = torch.clamp(first, min=0.0)
    scale = torch.clamp(torch.abs(first), min=step_floor)
    prev_N = torch.zeros_like(first)
    wcount = torch.zeros(first.shape[:-1], dtype=torch.int32, device=P_band.device)
    rain_ema = torch.zeros(first.shape[:-1], dtype=torch.float32, device=P_band.device)
    outs = []
    for t in range(T):
        Pt = P_band[..., t]
        raint = is_rain[..., t]
        allow = (wcount < warmup_need) | (~raint)
        err = Pt - tracker
        scale_new = scale_alpha * scale + (1.0 - scale_alpha) * torch.abs(err)
        step_sz = eta * torch.clamp(scale_new, min=step_floor)
        if p.adaptive_q_enable:
            q_eff = p.q - (p.q - p.adaptive_q_min) * rain_ema
            q_eff = torch.clamp(q_eff, p.adaptive_q_min, p.q)[..., None]
            delta = torch.where(Pt >= tracker, q_eff * step_sz,
                                -(1.0 - q_eff) * step_sz)
        else:
            delta = torch.where(Pt >= tracker, p.q * step_sz,
                                -(1.0 - p.q) * step_sz)
        candidate = torch.clamp(tracker + delta, min=0.0)
        if t > 0:  # the first frame keeps the initial tracker and scale
            tracker = torch.where(allow[..., None], candidate, tracker)
            scale = scale_new
        lam = torch.where(tracker > prev_N, p.ema_up, p.ema_down)
        N = lam * prev_N + (1.0 - lam) * tracker if t > 0 else tracker
        N = torch.minimum(N, p.maxr * Pt)
        N = torch.clamp(N, min=0.0)
        outs.append(N)
        prev_N = N
        wcount = wcount + allow.to(torch.int32)
        rain_ema = p.adaptive_q_alpha * rain_ema + (
            1.0 - p.adaptive_q_alpha) * raint.to(torch.float32)
    return torch.stack(outs, dim=-1)


def _noise_psd_track_cuda(P_band: torch.Tensor, is_rain: torch.Tensor,
                          p: PsdTrackParams) -> torch.Tensor:
    K, T = P_band.shape[-2:]
    P3 = P_band.reshape(-1, K, T)
    rain = is_rain.reshape(-1, T).to(torch.uint8).contiguous()
    _kernels.require_cuda("noise_psd_track", P3, torch.float32, 3)
    _kernels.require_cuda("noise_psd_track(is_rain)", rain, torch.uint8, 2)
    if rain.shape[0] != P3.shape[0] or rain.device != P3.device:
        raise ValueError("noise_psd_track: is_rain must be (..., T) beside P_band (..., K, T)")
    eta, step_floor, warmup_need = _psd_derived(p)
    sa = float(p.ema_down)
    out = torch.empty_like(P3)
    lib = _kernels.build()
    with torch.cuda.device(P3.device):
        err = lib.lib.apt_noise_psd_track(
            P3.data_ptr(), rain.data_ptr(), out.data_ptr(), P3.shape[0], K, T,
            eta, sa, 1.0 - sa, step_floor, warmup_need, p.q, -(1.0 - p.q),
            int(p.adaptive_q_enable), p.adaptive_q_min, p.q - p.adaptive_q_min,
            p.ema_up, p.ema_down, p.maxr, p.adaptive_q_alpha,
            1.0 - p.adaptive_q_alpha, _kernels.stream_of(P3),
        )
    lib.check(err, "noise_psd_track")
    _kernels.count("noise_psd_track")
    return out.reshape(P_band.shape)


def noise_psd_track(P_band: torch.Tensor, is_rain: torch.Tensor,
                    params: PsdTrackParams) -> torch.Tensor:
    """Track the noise PSD of a band block over time.

    ``P_band`` (..., K, T) linear power; ``is_rain`` (..., T) bool, frames
    excluded from updates after warm-up.  Returns ``N_band`` (..., K, T).
    """
    P_band = P_band.to(torch.float32)
    is_rain = is_rain.to(torch.bool)
    if P_band.shape[-1] == 0:
        return P_band.clone()
    if P_band.device.type == "cpu":
        return _noise_psd_track_plain(P_band, is_rain, params)
    return _noise_psd_track_cuda(P_band.contiguous(), is_rain, params)


# ---------------------------------------------------------------------------
# Causal smoothing (plain tensor code)
# ---------------------------------------------------------------------------


def causal_time_median(X: torch.Tensor, L: int) -> torch.Tensor:
    """Causal median over the last axis, window ``[t-L+1, t]``
    (``trackers.py:204-232``): even ``L`` is bumped to ``L+1``; early frames
    use the shorter history."""
    if L <= 1:
        return X
    if L % 2 == 0:
        L += 1
    T = X.shape[-1]
    big = torch.finfo(X.dtype).max
    Xp = tnf.pad(X, (L - 1, 0), value=big)
    ws = torch.sort(Xp.unfold(-1, L, 1), dim=-1).values  # (..., T, L)
    count = np.minimum(np.arange(T) + 1, L)
    lo = torch.as_tensor((count - 1) // 2, device=X.device)
    hi = torch.as_tensor(count // 2, device=X.device)
    idx_shape = ws.shape[:-1] + (1,)
    v_lo = torch.gather(ws, -1, lo[:, None].expand(idx_shape)).squeeze(-1)
    v_hi = torch.gather(ws, -1, hi[:, None].expand(idx_shape)).squeeze(-1)
    return 0.5 * (v_lo + v_hi)


def causal_time_mean(X: torch.Tensor, L: int) -> torch.Tensor:
    """Causal moving average over the last axis, window ``[t-L+1, t]``
    (``trackers.py:235-248``)."""
    if L <= 1:
        return X
    T = X.shape[-1]
    csum = torch.cumsum(X, dim=-1)
    shifted = tnf.pad(csum[..., :-L], (L, 0))[..., :T]
    count = torch.as_tensor(np.minimum(np.arange(T) + 1, L), dtype=X.dtype,
                            device=X.device)
    return (csum - shifted) / count
