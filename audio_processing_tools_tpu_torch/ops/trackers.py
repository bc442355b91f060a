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
    plain tensor code;
  * the streaming carry forms (``:256-385``): :func:`baseline_carry_init`
    and :func:`causal_low_quantile_baseline_chunk` (K3 with a carry in and
    out), :func:`psd_carry_init`, :func:`make_psd_track_step` (the one-frame
    transition, plain tensor code) and :func:`noise_psd_track_chunk` (K2 with
    a carry in and out).  The kernels take the carries as optional pointers,
    so the offline and the chunked calls run the same walk.

The JAX package runs the recurrences as ``lax.scan``.  Their plain
versions here are Python loops over frames that mirror the scan steps
operation for operation, including which constants are rounded to float32
in double precision and which are computed in float32; the kernels mirror
the loops the same way, so the two give the same bits.  A CPU tensor takes
the plain loop; a CUDA tensor launches the kernel or raises.

Both kernels stage tiles of frames in shared memory; their launch plan is
:func:`tracker_launch_plan`, which the C launchers check against their own,
so the two change together.  K2 reads its input in place through a clip
and a row stride, so the engine's band view ``P[:, rows, :]`` needs no copy.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as tnf

from audio_processing_tools_tpu_torch import _kernels

#: threads per block of K2 and K3: one warp walks the lanes, three load and store
TRACKER_THREADS = 128
#: lanes per block at most: one walker warp
TRACKER_MAX_LANES = 32
#: blocks the plan aims for, one per SM of an H100
TRACKER_TARGET_BLOCKS = 132
#: frames per staged tile
TRACKER_FRAME_TILE = 64
#: dynamic shared memory one block may use on Hopper
SMEM_LIMIT = 232_448
_INT_MAX = 2**31 - 1
#: the kernels the plan is for, and whether each stages a rain mask
_TRACKER_KERNELS = {"noise_psd_track": True, "causal_low_quantile_baseline": False}


class TrackerPlan(NamedTuple):
    lanes_per_block: int
    frame_tile: int
    threads: int
    smem_bytes: int  # dynamic shared memory per block
    grid: int  # blocks
    n_tiles: int  # frame tiles per lane


def tracker_launch_plan(kernel: str, lanes: int, T: int) -> TrackerPlan:
    """The launch plan of K2 (``"noise_psd_track"``) or K3
    (``"causal_low_quantile_baseline"``) for ``lanes`` rows of ``T`` frames,
    as ``lanes_per_block_for`` / ``smem_bytes_for`` in ``csrc/trackers.cu``.

    Lanes per block: the largest power of two up to 32 that still gives
    :data:`TRACKER_TARGET_BLOCKS` blocks, else 1.  Shared memory: two input
    and two output tiles of ``lanes_per_block`` rows of 65 floats, and for K2
    two rain tiles of as many rows of 17 words.  Raises ``ValueError`` for
    what the C launcher refuses: an unknown kernel, no lanes or frames, or
    more than ``2**31 - 1`` of either.
    """
    if kernel not in _TRACKER_KERNELS:
        raise ValueError(f"no tracker kernel {kernel!r}; expected one of {sorted(_TRACKER_KERNELS)}")
    if not (1 <= lanes <= _INT_MAX and 1 <= T <= _INT_MAX):
        raise ValueError(f"{kernel}: needs 1 to 2**31 - 1 lanes and frames; got {lanes} x {T}")
    L = TRACKER_MAX_LANES
    while L > 1 and -(-lanes // L) < TRACKER_TARGET_BLOCKS:
        L //= 2
    smem = 16 * L * (TRACKER_FRAME_TILE + 1)
    if _TRACKER_KERNELS[kernel]:
        smem += 8 * L * (TRACKER_FRAME_TILE // 4 + 1)
    return TrackerPlan(L, TRACKER_FRAME_TILE, TRACKER_THREADS, smem, -(-lanes // L),
                       -(-T // TRACKER_FRAME_TILE))


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


def baseline_carry_init(x0: torch.Tensor, floor: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Initial ``(baseline, scale)`` carry from the first sample
    (``trackers.py:256-259``)."""
    floor = float(max(floor, 1e-12))
    return torch.clamp(x0, min=floor), torch.clamp(torch.abs(x0), min=floor)


def _baseline_plain(x: torch.Tensor, c: _BaselineConsts, carry=None):
    """The scan of ``trackers.py:65-73`` as a loop, plus the ``:77-79``
    epilogue.  Without ``carry`` it starts from frame 0 and returns the
    baseline; with it, it returns ``(baseline, new_carry)``."""
    T = x.shape[-1]
    baseline, scale = carry if carry is not None else baseline_carry_init(x[..., 0], c.floor)
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
    out = torch.clamp(out, min=c.floor)
    return out if carry is None else (out, (baseline, scale))


def _baseline_cuda(x: torch.Tensor, c: _BaselineConsts, carry=None):
    T = x.shape[-1]
    rows = x.reshape(-1, T)
    R = rows.shape[0]
    _kernels.require_cuda("causal_low_quantile_baseline", rows, torch.float32, 2)
    plan = tracker_launch_plan("causal_low_quantile_baseline", R, T)
    out = torch.empty_like(rows)
    ptrs = [None] * 4
    if carry is not None:
        cin = [_kernels.carry_vector("causal_low_quantile_baseline", v, rows, R, torch.float32)
               for v in carry]
        cout = [torch.empty(R, dtype=torch.float32, device=x.device) for _ in range(2)]
        ptrs = [v.data_ptr() for v in cin + cout]
    lib = _kernels.build()
    with torch.cuda.device(x.device):
        err = lib.lib.apt_causal_low_quantile_baseline(
            rows.data_ptr(), out.data_ptr(), R, T, *plan,
            c.q, -(1.0 - c.q), c.eta, c.scale_alpha, 1.0 - c.scale_alpha,
            c.floor, *ptrs, _kernels.stream_of(rows),
        )
    lib.check(err, "causal_low_quantile_baseline")
    _kernels.count("causal_low_quantile_baseline")
    out = out.reshape(x.shape)
    if carry is None:
        return out
    return out, tuple(v.reshape(x.shape[:-1]) for v in cout)


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


def causal_low_quantile_baseline_chunk(
    x: torch.Tensor,
    carry: Tuple[torch.Tensor, torch.Tensor],
    *,
    q_percent: float,
    samples_per_sec: float,
    win_sec: float,
    floor: float = 1e-6,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One chunk of :func:`causal_low_quantile_baseline` with an explicit
    carry (``trackers.py:262-302``): threading the carry over consecutive
    chunks gives the bits of one call on the whole row.  ``carry`` is
    ``(baseline, scale)`` of the input's leading shape, from
    :func:`baseline_carry_init` or the previous chunk.  Returns
    ``(baseline, new_carry)``."""
    c = _baseline_consts(q_percent, samples_per_sec, win_sec, 0.0, floor)
    x = x.to(torch.float32)
    if x.shape[-1] == 0:
        return x, carry
    if x.device.type == "cpu":
        return _baseline_plain(x, c, carry)
    return _baseline_cuda(x.contiguous(), c, carry)


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


#: K2's carry: tracker, scale and last output (..., K); warm-up count,
#: rain EMA and whether no frame was seen yet (...,)
PsdCarry = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                 torch.Tensor]


def psd_carry_init(first_band_frame: torch.Tensor, params: PsdTrackParams) -> PsdCarry:
    """Initial PSD-tracker carry from the first band frame (..., K)
    (``trackers.py:305-316``); the flag ``is_first`` has the leading shape."""
    step_floor = float(max(params.eps, 1e-9))
    first = first_band_frame.to(torch.float32)
    lead, dev = first.shape[:-1], first.device
    return (torch.clamp(first, min=0.0), torch.clamp(torch.abs(first), min=step_floor),
            torch.zeros_like(first), torch.zeros(lead, dtype=torch.int32, device=dev),
            torch.zeros(lead, dtype=torch.float32, device=dev),
            torch.ones(lead, dtype=torch.bool, device=dev))


def make_psd_track_step(params: PsdTrackParams):
    """The tracker's one-frame transition (``trackers.py:319-369``), plain
    tensor code: ``step(carry, (P_t, rain_t)) -> (new_carry, N_t)`` with
    ``P_t`` (..., K) and ``rain_t`` (...,) bool.  K2 and the streaming
    suppressor's kernel K8 give its values bit for bit."""
    p = params
    eta, step_floor, warmup_need = _psd_derived(p)
    scale_alpha = float(p.ema_down)

    def step(carry: PsdCarry, inp):
        tracker, scale, prev_N, wcount, rain_ema, is_first = carry
        Pt, raint = inp
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
        # the stream's first frame keeps the initial tracker and scale
        first = is_first[..., None]
        tracker_new = torch.where(first | ~allow[..., None], tracker, candidate)
        scale_out = torch.where(first, scale, scale_new)
        lam = torch.where(tracker_new > prev_N, p.ema_up, p.ema_down)
        N = torch.where(first, tracker_new, lam * prev_N + (1.0 - lam) * tracker_new)
        N = torch.minimum(N, p.maxr * Pt)
        N = torch.clamp(N, min=0.0)
        wcount = wcount + allow.to(torch.int32)
        rain_ema = p.adaptive_q_alpha * rain_ema + (
            1.0 - p.adaptive_q_alpha) * raint.to(torch.float32)
        return (tracker_new, scale_out, N, wcount, rain_ema, torch.zeros_like(is_first)), N

    return step


def _noise_psd_track_chunk_plain(P_band: torch.Tensor, is_rain: torch.Tensor,
                                 carry: PsdCarry, p: PsdTrackParams):
    """:func:`make_psd_track_step` as a loop over frames; returns
    ``(N_band, new_carry)``."""
    step = make_psd_track_step(p)
    outs = []
    for t in range(P_band.shape[-1]):
        carry, N = step(carry, (P_band[..., t], is_rain[..., t]))
        outs.append(N)
    return torch.stack(outs, dim=-1), carry


def _noise_psd_track_plain(P_band: torch.Tensor, is_rain: torch.Tensor,
                           p: PsdTrackParams) -> torch.Tensor:
    """The scan of ``trackers.py:148-200``: the chunk loop from the carry
    that frame 0 gives."""
    return _noise_psd_track_chunk_plain(P_band, is_rain, psd_carry_init(P_band[..., 0], p), p)[0]


def _band_strides(P3: torch.Tensor) -> Tuple[int, int]:
    """Clip and row strides, in elements, of a (B, K, T) band block that K2
    reads in place: any strides with the frames of each row contiguous (the
    engine's view ``P[:, rows, :]`` of the spectrogram is one).  Raises
    ``ValueError`` on any other layout."""
    if P3.dim() != 3:
        raise ValueError(f"noise_psd_track: expected (B, K, T), got shape {tuple(P3.shape)}")
    if P3.shape[-1] > 1 and P3.stride(-1) != 1:
        raise ValueError(f"noise_psd_track: the frames of each row must be contiguous; "
                         f"got strides {P3.stride()}")
    return P3.stride(0), P3.stride(1)


def _noise_psd_track_cuda(P_band: torch.Tensor, is_rain: torch.Tensor,
                          p: PsdTrackParams, carry: PsdCarry | None = None):
    """K2 from frame 0 (returns ``N_band``), or from ``carry`` (returns
    ``(N_band, new_carry)``)."""
    K, T = P_band.shape[-2:]
    P3 = P_band.reshape(-1, K, T)  # a view for the engine's band block
    if P3.device.type != "cuda":
        raise ValueError(f"noise_psd_track: expected a CUDA tensor, got device {P3.device}")
    if P3.dtype != torch.float32:
        raise TypeError(f"noise_psd_track: expected torch.float32, got {P3.dtype}")
    clip_stride, row_stride = _band_strides(P3)
    # a bool mask is read as its bytes, without a copy
    rain = is_rain.to(torch.bool).reshape(-1, T).view(torch.uint8).contiguous()
    _kernels.require_cuda("noise_psd_track(is_rain)", rain, torch.uint8, 2)
    if rain.shape[0] != P3.shape[0] or rain.device != P3.device:
        raise ValueError("noise_psd_track: is_rain must be (..., T) beside P_band (..., K, T)")
    plan = tracker_launch_plan("noise_psd_track", P3.shape[0] * K, T)
    eta, step_floor, warmup_need = _psd_derived(p)
    sa = float(p.ema_down)
    out = torch.empty(P3.shape, dtype=torch.float32, device=P3.device)
    B = P3.shape[0]
    ptrs = [None] * 11
    if carry is not None:
        name = "noise_psd_track"
        cin = [_kernels.carry_vector(name, v, P3, B * K, torch.float32) for v in carry[:3]]
        cin += [_kernels.carry_vector(name, carry[3], P3, B, torch.int32),
                _kernels.carry_vector(name, carry[4], P3, B, torch.float32),
                _kernels.carry_vector(name, carry[5], P3, B, torch.bool).view(torch.uint8)]
        cout = [torch.empty(B * K, dtype=torch.float32, device=P3.device) for _ in range(3)]
        cout += [torch.empty(B, dtype=torch.int32, device=P3.device),
                 torch.empty(B, dtype=torch.float32, device=P3.device)]
        ptrs = [v.data_ptr() for v in cin + cout]
    lib = _kernels.build()
    with torch.cuda.device(P3.device):
        err = lib.lib.apt_noise_psd_track(
            P3.data_ptr(), rain.data_ptr(), out.data_ptr(), B, K, T,
            clip_stride, row_stride, *plan,
            eta, sa, 1.0 - sa, step_floor, warmup_need, p.q, -(1.0 - p.q),
            int(p.adaptive_q_enable), p.adaptive_q_min, p.q - p.adaptive_q_min,
            p.ema_up, p.ema_down, p.maxr, p.adaptive_q_alpha,
            1.0 - p.adaptive_q_alpha, *ptrs, _kernels.stream_of(P3),
        )
    lib.check(err, "noise_psd_track")
    _kernels.count("noise_psd_track")
    out = out.reshape(P_band.shape)
    if carry is None:
        return out
    lane_shape, clip_shape = P_band.shape[:-1], P_band.shape[:-2]
    return out, (*(v.reshape(lane_shape) for v in cout[:3]),
                 *(v.reshape(clip_shape) for v in cout[3:]),
                 torch.zeros(clip_shape, dtype=torch.bool, device=P3.device))


def noise_psd_track(P_band: torch.Tensor, is_rain: torch.Tensor,
                    params: PsdTrackParams) -> torch.Tensor:
    """Track the noise PSD of a band block over time.

    ``P_band`` (..., K, T) linear power; ``is_rain`` (..., T) bool, frames
    excluded from updates after warm-up.  Returns ``N_band`` (..., K, T),
    contiguous.  On a CUDA tensor whose frames are contiguous (a view of
    band rows, say) the kernel reads ``P_band`` in place.
    """
    P_band = P_band.to(torch.float32)
    is_rain = is_rain.to(torch.bool)
    if P_band.shape[-1] == 0:
        return P_band.clone()
    if P_band.device.type == "cpu":
        return _noise_psd_track_plain(P_band, is_rain, params)
    if P_band.shape[-1] > 1 and P_band.stride(-1) != 1:
        P_band = P_band.contiguous()
    return _noise_psd_track_cuda(P_band, is_rain, params)


def noise_psd_track_chunk(P_band: torch.Tensor, is_rain: torch.Tensor, carry: PsdCarry,
                          params: PsdTrackParams):
    """One chunk of :func:`noise_psd_track` with an explicit carry
    (``trackers.py:372-385``): threading the carry over consecutive chunks
    gives the bits of one call on the whole stream.  ``carry`` from
    :func:`psd_carry_init` or the previous chunk.  Returns
    ``(N_band, new_carry)``."""
    P_band = P_band.to(torch.float32)
    is_rain = is_rain.to(torch.bool)
    if P_band.shape[-1] == 0:
        return P_band.clone(), carry
    if P_band.device.type == "cpu":
        return _noise_psd_track_chunk_plain(P_band, is_rain, carry, params)
    if P_band.shape[-1] > 1 and P_band.stride(-1) != 1:
        P_band = P_band.contiguous()
    return _noise_psd_track_cuda(P_band, is_rain, params, carry)


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


_CUMSUM_BASE = 16


def _cumsum_xla_order(x: torch.Tensor) -> torch.Tensor:
    """Float32 cumulative sum over the last axis, with the additions of the
    JAX package's compiled ``jnp.cumsum`` in their order: blocks of 16 summed
    in sequence, the block totals scanned the same way (recursively), and
    each block offset by the sum of the blocks before it.  Each step is an
    elementwise addition, so any device gives the same bits."""
    n = x.shape[-1]
    if n <= _CUMSUM_BASE:
        out = [x[..., 0]]
        for k in range(1, n):
            out.append(out[-1] + x[..., k])
        return torch.stack(out, dim=-1)
    m = -(-n // _CUMSUM_BASE)
    blocks = tnf.pad(x, (0, m * _CUMSUM_BASE - n)).reshape(x.shape[:-1] + (m, _CUMSUM_BASE))
    inner = _cumsum_xla_order(blocks)
    before = tnf.pad(_cumsum_xla_order(inner[..., -1]), (1, 0))[..., :m]
    return (inner + before[..., None]).reshape(x.shape[:-1] + (m * _CUMSUM_BASE,))[..., :n]


def causal_time_mean(X: torch.Tensor, L: int) -> torch.Tensor:
    """Causal moving average over the last axis, window ``[t-L+1, t]``
    (``trackers.py:235-248``): a difference of two float32 running sums.

    That difference cancels badly where quiet frames follow loud ones, and
    the JAX package's result there is its rounding, not the mean; so the
    running sum adds in the JAX program's order and gives its bits."""
    if L <= 1:
        return X
    T = X.shape[-1]
    csum = _cumsum_xla_order(X)
    shifted = tnf.pad(csum[..., :-L], (L, 0))[..., :T]
    count = torch.as_tensor(np.minimum(np.arange(T) + 1, L), dtype=X.dtype,
                            device=X.device)
    return (csum - shifted) / count
