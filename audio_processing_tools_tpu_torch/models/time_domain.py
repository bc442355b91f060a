"""Stage-2 time-domain droplet confirmation, batched over a clip's frames.

Counterpart of ``audio_processing_tools_tpu/models/time_domain.py``
(``:32-308``).  Every analysis window of a clip is a row: the window is
``prev_context_hops`` hops, the frame and ``future_context_hops`` hops,
clipped to the signal (``[t-128, t+256)``, 384 samples, by default) and
zero-padded to the longest.  The Hilbert envelope is taken per group of
equal window lengths (``torch.fft``), then smoothed; the peak mask is the
local maxima, the distance filter (kernel K9 on the card,
``ops/peaks.py::select_peaks_by_distance``) and the prominence gate; crest
factor and kurtosis come from the raw window.  The stage-1 mask is applied
at the end (compute everywhere, mask at the end), as in JAX.

Bits: the smoothing is XLA's: a dot product of the 22-tap boxcar at
``HIGHEST`` that XLA's CPU emitter accumulates as a chain of fused
multiply-adds, reproduced here in float64 rounded to float32 at each step
(exact: each product is exact in float64).  Crest factor and kurtosis sums
are :func:`~audio_processing_tools_tpu_torch.ops.stats.tree_sum` (the card
gives the CPU's bits; against XLA's own order, within 1e-5).  The FFT
libraries differ from XLA's in the last bits of the envelope.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from audio_processing_tools_tpu_torch.ops._device import device_constant, f32
from audio_processing_tools_tpu_torch.ops.filters import design_bandpass, sosfilt, sosfiltfilt
from audio_processing_tools_tpu_torch.ops.peaks import (
    local_maxima,
    peak_prominences,
    select_peaks_by_distance,
)
from audio_processing_tools_tpu_torch.ops.stats import tree_sum

_PROMINENCE_ROWS = 256  # windows per prominence block: bounds its (rows, L, L) planes


@dataclass(frozen=True)
class TimeDomainDetectorConfig:
    """(``time_domain.py:32-49``)."""

    fs: int = 11162
    n_fft: int = 256
    hop: int = 128
    prev_context_hops: int = 1
    future_context_hops: int = 0
    mode_bands: Optional[Tuple[Tuple[float, float], ...]] = None
    operating_band: Tuple[float, float] = (400.0, 3500.0)
    bp_order: int = 4
    envelope_smooth_ms: float = 2.0
    peak_prominence_ratio: float = 0.25
    peak_distance_ms: float = 4.0
    min_crest_factor: float = 3.0
    min_kurtosis: float = 3.5
    eps: float = 1e-9


def build_time_domain_config(params: Dict[str, Any]) -> TimeDomainDetectorConfig:
    """Framework-params builder (``time_domain.py:52-85``)."""
    td = dict(params.get("time_domain", {}) or {})
    det = dict(params.get("detector", {}) or {})

    mode_bands_raw = det.get("mode_bands", None)
    mode_bands = None
    if isinstance(mode_bands_raw, (list, tuple)):
        bands = []
        for bb in mode_bands_raw:
            try:
                lo, hi = float(bb[0]), float(bb[1])
            except Exception:
                continue
            if np.isfinite(lo) and np.isfinite(hi) and hi > lo:
                bands.append((lo, hi))
        mode_bands = tuple(bands) if bands else None

    return TimeDomainDetectorConfig(
        fs=int(params.get("sample_rate", params.get("fs", 11162))),
        n_fft=int(params.get("n_fft", 256)),
        hop=int(params.get("hop", 128)),
        prev_context_hops=int(td.get("prev_context_hops", 1)),
        future_context_hops=int(td.get("future_context_hops", 0)),
        mode_bands=mode_bands,
        operating_band=tuple(params.get("operating_band", (400.0, 3500.0))),
        bp_order=int(td.get("bp_order", 4)),
        envelope_smooth_ms=float(td.get("envelope_smooth_ms", 2.0)),
        peak_prominence_ratio=float(td.get("peak_prominence_ratio", 0.25)),
        peak_distance_ms=float(td.get("peak_distance_ms", 4.0)),
        min_crest_factor=float(td.get("min_crest_factor", 3.0)),
        min_kurtosis=float(td.get("min_kurtosis", 3.5)),
        eps=float(td.get("eps", 1e-9)),
    )


def hilbert_envelope(seg: torch.Tensor) -> torch.Tensor:
    """|analytic signal| over the last axis (scipy ``hilbert``;
    ``time_domain.py:88-100``): a complex FFT, the one-sided weights, the
    inverse FFT."""
    n = seg.shape[-1]

    def weights():
        h = np.zeros(n)
        if n % 2 == 0:
            h[0] = h[n // 2] = 1.0
            h[1 : n // 2] = 2.0
        else:
            h[0] = 1.0
            h[1 : (n + 1) // 2] = 2.0
        return h

    X = torch.fft.fft(seg.to(torch.complex64), dim=-1)
    analytic = torch.fft.ifft(X * device_constant(("hilbert", n), seg.device, weights), dim=-1)
    return torch.abs(analytic)


def _mode_signal(x: torch.Tensor, cfg: TimeDomainDetectorConfig, sr: int) -> torch.Tensor:
    """Summed mode-band band-pass signal (``time_domain.py:103-122``): each
    band zero-phase (``sosfiltfilt``), or causal (``sosfilt``, kernel K4 on
    the card) when the input is no longer than scipy's pad length."""
    bands: List[Tuple[float, float]] = []
    if cfg.mode_bands:
        bands = [(float(a), float(b)) for a, b in cfg.mode_bands]
    if not bands:
        bands = [tuple(map(float, cfg.operating_band))]
    y = torch.zeros_like(x)
    for lo, hi in bands:
        sos = design_bandpass(sr, lo, hi, cfg.bp_order)
        n_sections = sos.shape[0]
        ntaps = 2 * n_sections + 1 - int(min((sos[:, 2] == 0).sum(), (sos[:, 5] == 0).sum()))
        if x.shape[-1] > 3 * ntaps:
            y = y + sosfiltfilt(sos, x)
        else:
            y = y + sosfilt(sos, x)
    return y


def _smooth(env: torch.Tensor, smooth_len: int) -> torch.Tensor:
    """``np.convolve(env, ones(m) / m, "same")`` on every row as the JAX
    package computes it: the window ``[t - m//2, t + m - 1 - m//2]`` (the
    convolution reverses the kernel), zeros past the row, and XLA's chain of
    fused multiply-adds over the taps in order.  A row shorter than the
    others is zero past its length, so all rows take one pass."""
    pad_l = smooth_len // 2
    pad_r = smooth_len - 1 - pad_l
    n = env.shape[-1]
    ep = torch.nn.functional.pad(env, (pad_l, pad_r)).to(torch.float64)
    k = float(np.float32(1.0 / smooth_len))
    acc = torch.zeros_like(env)
    for i in range(smooth_len):
        # k * e is exact in float64, so one rounding to float32 is the FMA's
        acc = torch.add(acc.to(torch.float64), ep[..., i : i + n], alpha=k).to(torch.float32)
    return acc


def _analyze_windows(env: torch.Tensor, seg: torch.Tensor, vmask: torch.Tensor,
                     cnt: torch.Tensor, cfg: TimeDomainDetectorConfig, sr: int):
    """Batched window analysis (``time_domain.py:125-174``) of the (n_win, L)
    envelope and raw windows; ``vmask`` marks each row's valid samples and
    ``cnt`` holds its length (float32)."""
    dev = env.device
    env_max = torch.amax(torch.where(vmask, env, float("-inf")), dim=-1)
    prominence_thr = torch.maximum(f32(cfg.eps, dev), f32(cfg.peak_prominence_ratio, dev) * env_max)
    distance = max(1, int(round(cfg.peak_distance_ms * 1e-3 * sr)))

    # scipy find_peaks order: local maxima -> distance -> prominence
    env_z = torch.where(vmask, env, 0.0)
    is_max = local_maxima(env_z) & vmask
    kept = select_peaks_by_distance(env_z, is_max, distance)
    prom = torch.cat([peak_prominences(env_z[i : i + _PROMINENCE_ROWS],
                                       kept[i : i + _PROMINENCE_ROWS])
                      for i in range(0, env_z.shape[0], _PROMINENCE_ROWS)])
    peaks = kept & (prom >= prominence_thr[:, None])
    n_peaks = torch.sum(peaks, dim=-1).to(torch.int32)

    # whole-window crest and kurtosis on the raw segment
    eps = f32(cfg.eps, dev)
    den = torch.clamp(cnt, min=1.0)
    seg_z = torch.where(vmask, seg, 0.0)
    msq = tree_sum(seg_z * seg_z) / den
    rms = torch.sqrt(msq + eps)
    peak_abs = torch.amax(torch.where(vmask, torch.abs(seg), 0.0), dim=-1)
    crest = peak_abs / torch.maximum(rms, eps)

    mean = tree_sum(seg_z) / den
    d = torch.where(vmask, seg - mean[:, None], 0.0)
    dd = d * d
    m2 = tree_sum(dd) / den
    m4 = tree_sum(dd * dd) / den
    g2 = m4 / torch.where(m2 > 0, m2 * m2, 1.0) - 3.0
    nf = cnt
    G2 = ((nf + 1.0) * g2 + 6.0) * (nf - 1.0) / torch.clamp((nf - 2.0) * (nf - 3.0), min=1.0)
    kurt = torch.where((m2 > 0) & (nf >= 4), G2 + 3.0, 0.0)
    kurt = torch.where(torch.isfinite(kurt), kurt, 0.0)

    confirmed = ((n_peaks > 0) & (crest >= f32(cfg.min_crest_factor, dev))
                 & (kurt >= f32(cfg.min_kurtosis, dev)))
    return confirmed, n_peaks, crest, kurt, peaks


class _WindowPlan:
    """A clip length's windows on one device: the gather indices (T, L), the
    valid mask, the lengths, and the row groups of equal length."""

    def __init__(self, bounds: List[Tuple[int, int]], device: torch.device):
        lengths = np.array([e - s for s, e in bounds], np.int64)
        T = len(bounds)
        L = int(lengths.max()) if T else 0
        idx = np.zeros((T, L), np.int64)
        for t, (s, e) in enumerate(bounds):
            idx[t, : e - s] = np.arange(s, e)
        self.L = L
        self.idx = torch.from_numpy(idx).to(device)
        self.valid = torch.from_numpy(np.arange(L)[None, :] < lengths[:, None]).to(device)
        self.cnt = torch.from_numpy(lengths.astype(np.float32)).to(device)
        self.groups = [(int(ln), torch.from_numpy(np.flatnonzero(lengths == ln)).to(device))
                       for ln in np.unique(lengths)]


class TimeDomainRainDetector:
    """Stage-2 confirmation over stage-1 rain frames (``time_domain.py:177-308``),
    on ``device``."""

    def __init__(self, config: Optional[TimeDomainDetectorConfig] = None,
                 device: str | torch.device = "cuda"):
        self.cfg = config
        self.device = torch.device(device)
        self._is_setup = config is not None
        self._plans: Dict[Any, _WindowPlan] = {}

    def setup(self, params: Dict[str, Any]) -> None:
        if self._is_setup:
            return
        self.cfg = build_time_domain_config(params)
        self._is_setup = True

    def _window_bounds(self, t: int, n: int) -> Tuple[int, int]:
        cfg = self.cfg
        frame_start = t * cfg.hop
        start = max(0, frame_start - max(0, cfg.prev_context_hops) * cfg.hop)
        end = min(n, frame_start + max(1, cfg.n_fft)
                  + max(0, cfg.future_context_hops) * cfg.hop)
        return start, end

    def _run(self, x: torch.Tensor, sr: int, T: int) -> Dict[str, torch.Tensor]:
        """``_traced`` (``time_domain.py:199-252``) on the card or the CPU."""
        cfg = self.cfg
        n = x.shape[-1]
        x_mode = _mode_signal(x, cfg, sr)

        key = (n, T)
        plan = self._plans.get(key)
        if plan is None:
            plan = _WindowPlan([self._window_bounds(t, n) for t in range(T)], x.device)
            self._plans[key] = plan
        seg = torch.where(plan.valid, x_mode[plan.idx], 0.0)

        # the Hilbert envelope of each window over its clipped length, one
        # FFT size per group of equal lengths
        env = torch.zeros_like(seg)
        for ln, rows in plan.groups:
            env[rows, :ln] = hilbert_envelope(seg[rows, :ln])
        smooth_len = max(1, int(round(cfg.envelope_smooth_ms * 1e-3 * sr)))
        if smooth_len > 1:
            env = _smooth(env, smooth_len)

        confirmed, n_peaks, crest, kurt, peak_mask = _analyze_windows(
            env, seg, plan.valid, plan.cnt, cfg, sr)
        return {
            "confirmed_mask": confirmed,
            "confirmed_counts": torch.where(confirmed, n_peaks, 0),
            "crest_factor": crest,
            "kurtosis": kurt,
            "candidate_peaks": n_peaks,
            "x_mode": x_mode,
            "peak_mask": peak_mask,
        }

    def process(self, x, stage1_is_rain: Optional[np.ndarray] = None,
                sr: Optional[int] = None) -> Dict[str, Any]:
        """Reference-shaped output dict (``time_domain.py:254-308``) with NumPy
        arrays; rows outside the stage-1 mask are zeroed."""
        if self.cfg is None:
            self.setup({"sample_rate": sr or 11162})
        cfg = self.cfg
        if sr is None:
            sr = cfg.fs
        xt = torch.from_numpy(np.asarray(x, np.float32).reshape(-1)).to(self.device)
        size = xt.shape[0]

        if stage1_is_rain is not None:
            stage1_is_rain = np.asarray(stage1_is_rain, bool).reshape(-1)
            T = int(stage1_is_rain.shape[0])
            run_mask = stage1_is_rain
        else:
            T = 0 if size < cfg.n_fft else 1 + (size - cfg.n_fft) // cfg.hop
            run_mask = np.ones(T, bool)
            stage1_is_rain = run_mask.copy()

        if T == 0:  # the JAX program fails on its empty reductions too
            raise ValueError(f"no analysis window: {size} samples is shorter than n_fft "
                             f"{cfg.n_fft} (or the stage-1 mask is empty)")
        out = {k: v.cpu().numpy() for k, v in self._run(xt, int(sr), T).items()}

        rm = run_mask
        details = []
        for t in np.flatnonzero(rm):
            s, e = self._window_bounds(int(t), size)
            details.append({
                "frame_idx": int(t),
                "window": (s, e),
                "confirmed": bool(out["confirmed_mask"][t]),
                "confirmed_raindrops": int(out["confirmed_counts"][t]),
                "n_candidate_peaks": int(out["candidate_peaks"][t]),
                "crest_factor": float(out["crest_factor"][t]),
                "kurtosis": float(out["kurtosis"][t]),
                "peak_indices_local": np.flatnonzero(out["peak_mask"][t]).astype(np.int32),
            })

        return {
            "confirmed_mask": out["confirmed_mask"] & rm,
            "confirmed_counts": np.where(rm, out["confirmed_counts"], 0),
            "crest_factor": np.where(rm, out["crest_factor"], 0.0),
            "kurtosis": np.where(rm, out["kurtosis"], 0.0),
            "candidate_peaks": np.where(rm, out["candidate_peaks"], 0),
            "details": details,
            "x_mode": out["x_mode"],
            "stage1_is_rain": stage1_is_rain,
            "run_mask": rm,
        }
