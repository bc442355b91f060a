"""Peak detection along the last axis as fixed-shape masks, batched.

Counterpart of ``audio_processing_tools_tpu/ops/peaks.py``:
:func:`local_maxima` (``:27-71``), :func:`peak_prominences` (``:74-105``)
and :func:`peak_widths_rel` (``:108-163``), in the JAX package's masked
O(N^2) forms, and :func:`select_peaks_by_distance` (``:185-208``), the
stage-2 confirmer's distance filter (``models/time_domain.py``), whose
``fori_loop`` is kernel K9 on the card (``csrc/peaks.cu``).
``torch.cummax`` takes the place of ``lax.cummax``, its ``reverse=True``
form through ``flip``.  ``find_peaks`` has no caller in the JAX package.
"""

from __future__ import annotations

import torch

from audio_processing_tools_tpu_torch import _kernels


def local_maxima(x: torch.Tensor) -> torch.Tensor:
    """Boolean mask of local maxima along the last axis, scipy's plateau
    rule included: a plateau marks its midpoint; the first and last samples
    never peak.  Each position finds the nearest strict change on each side
    with a running max over encoded boundary indices whose low bit carries
    the change's direction."""
    n = x.shape[-1]
    if n < 3:
        return torch.zeros(x.shape, dtype=torch.bool, device=x.device)

    # boundary j sits between samples j and j+1 (j = 0..n-2)
    chg = x[..., 1:] != x[..., :-1]
    up = (x[..., 1:] > x[..., :-1]).to(torch.int64)
    fall = (x[..., 1:] < x[..., :-1]).to(torch.int64)
    idx = torch.arange(n - 1, device=x.device)
    neg1 = torch.full(x.shape[:-1] + (1,), -1, dtype=torch.int64, device=x.device)

    # last change boundary j <= m-1, encoded j*2 + up
    enc_l = torch.where(chg, idx * 2 + up, -1)
    pos_enc = torch.cat([neg1, torch.cummax(enc_l, dim=-1).values], dim=-1)
    has_l = pos_enc >= 0
    s = torch.where(has_l, (pos_enc >> 1) + 1, 0)  # plateau start
    left_rise = has_l & ((pos_enc & 1) == 1)

    # next change boundary j >= m, encoded with the reversed index so the
    # running max from the right picks the smallest j
    enc_r = torch.where(chg, (n - 2 - idx) * 2 + fall, -1)
    rmax = torch.cummax(enc_r.flip(-1), dim=-1).values.flip(-1)
    nxt_enc = torch.cat([rmax, neg1], dim=-1)
    has_r = nxt_enc >= 0
    e = torch.where(has_r, (n - 2) - (nxt_enc >> 1), n - 1)  # plateau end
    right_fall = has_r & ((nxt_enc & 1) == 1)

    m = torch.arange(n, device=x.device)
    return left_rise & right_fall & (m == torch.div(s + e, 2, rounding_mode="floor"))


def peak_prominences(x: torch.Tensor, is_peak: torch.Tensor) -> torch.Tensor:
    """Prominence of every position, 0 where ``is_peak`` is false (scipy
    semantics: each side extends to a strictly higher sample or the border,
    its base is the side's minimum, the prominence is the peak less the
    higher base)."""
    n = x.shape[-1]
    # int32 positions: the (..., n, n) index planes are half the bytes of int64
    i = torch.arange(n, dtype=torch.int32, device=x.device)
    xi = x[..., :, None]  # peak position p -> row
    xj = x[..., None, :]  # scan position j -> col
    jj = i[None, :]
    pp = i[:, None]
    higher = xj > xi  # (..., p, j)
    inf = torch.tensor(torch.inf, dtype=x.dtype, device=x.device)

    # L(p) = max{j < p : x[j] > x[p]}, else -1; left base = min over (L, p]
    L = torch.amax(torch.where(higher & (jj < pp), jj, -1), dim=-1)
    in_left = (jj > L[..., :, None]) & (jj <= pp)
    left_base = torch.amin(torch.where(in_left, xj, inf), dim=-1)

    # R(p) = min{j > p : x[j] > x[p]}, else n; right base = min over [p, R)
    R = torch.amin(torch.where(higher & (jj > pp), jj, n), dim=-1)
    in_right = (jj >= pp) & (jj < R[..., :, None])
    right_base = torch.amin(torch.where(in_right, xj, inf), dim=-1)

    prom = x - torch.maximum(left_base, right_base)
    return torch.where(is_peak, prom, 0.0)


def _pick_at(xj: torch.Tensor, jj: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx[..., p]]`` per row p, as the JAX package's one-hot sum."""
    return torch.sum(torch.where(jj == idx[..., :, None], xj, 0.0), dim=-1)


def peak_widths_rel(x: torch.Tensor, is_peak: torch.Tensor,
                    prominences: torch.Tensor, rel_height: float = 0.5) -> torch.Tensor:
    """Width of each peak at ``x[p] - rel_height * prominence``, crossings
    interpolated linearly (scipy ``peak_widths``); 0 where not a peak."""
    n = x.shape[-1]
    j = torch.arange(n, device=x.device)
    pp = j[:, None]
    jj = j[None, :]
    h = x - rel_height * prominences  # (..., n) height per peak position
    xj = x[..., None, :]
    hb = h[..., :, None]

    # left: i_left = max{j < p : x[j] <= h}, crossing between i_left and i_left+1
    le = (jj < pp) & (xj <= hb)
    has_l = le.any(-1)
    i_l = torch.amax(torch.where(le, jj, -1), dim=-1)
    i_l_c = torch.clamp(i_l, min=0)
    x_il = _pick_at(xj, jj, i_l_c)
    x_il1 = _pick_at(xj, jj, torch.clamp(i_l_c + 1, max=n - 1))
    interp_l = torch.where(
        has_l & (x_il < h),
        (h - x_il) / torch.where(x_il1 != x_il, x_il1 - x_il, 1.0),
        0.0,
    )
    left_ip = torch.where(has_l, i_l_c.to(x.dtype) + interp_l, 0.0)

    # right: i_right = min{j > p : x[j] <= h}
    re = (jj > pp) & (xj <= hb)
    has_r = re.any(-1)
    i_r = torch.amin(torch.where(re, jj, n), dim=-1)
    i_r_c = torch.clamp(i_r, max=n - 1)
    x_ir = _pick_at(xj, jj, i_r_c)
    x_irm = _pick_at(xj, jj, torch.clamp(i_r_c - 1, min=0))
    interp_r = torch.where(
        has_r & (x_ir < h),
        (h - x_ir) / torch.where(x_irm != x_ir, x_irm - x_ir, 1.0),
        0.0,
    )
    right_ip = torch.where(has_r, i_r_c.to(x.dtype) - interp_r, float(n - 1))

    return torch.where(is_peak, right_ip - left_ip, 0.0)


K9_MAX_LENGTH = 1024  # csrc/peaks.cu: a warp a row, a 32-bit word of covered positions a lane


def _select_peaks_by_distance_plain(x: torch.Tensor, is_peak: torch.Tensor, distance: int,
                                    max_peaks: int) -> torch.Tensor:
    """The JAX loop on rows ``x`` (R, n), batched over rows: the
    ``min(max_peaks, n)`` first positions in the order tallest first, ties
    to the larger index (non-peaks count as -inf), each clearing ``keep``
    within ``(p - distance, p + distance)`` but at ``p`` while it is itself
    kept.  Peaks past the cap never clear others."""
    n = x.shape[-1]
    vals = torch.where(is_peak, x, float("-inf"))
    # lexsort((-arange(n), -vals)): a stable ascending sort of -vals over the
    # positions in reversed order, so ties keep the larger index first; torch
    # sorts NaN last and holds -0 equal to +0, as JAX's sort key does
    order = n - 1 - torch.sort(-vals.flip(-1), dim=-1, stable=True).indices
    idx = torch.arange(n, device=x.device)
    keep = is_peak.clone()
    for k in range(min(max_peaks, n)):
        p = order[:, k : k + 1]
        valid = is_peak.gather(1, p) & keep.gather(1, p)
        kill = (idx > p - distance) & (idx < p + distance) & (idx != p)
        keep &= ~(kill & valid)
    return keep & is_peak


def _select_peaks_by_distance_cuda(x: torch.Tensor, is_peak: torch.Tensor, distance: int,
                                   max_peaks: int) -> torch.Tensor:
    """K9 (``csrc/peaks.cu``): one warp a row.  The loop's step count
    ``min(max_peaks, n)`` is clamped at 0, as ``range`` and ``fori_loop``
    run no step for a negative cap; a distance outside ``[0, n]`` clears
    what its end of that range clears."""
    R, n = x.shape
    _kernels.require_cuda("select_peaks_by_distance", x, torch.float32, 2)
    _kernels.require_cuda("select_peaks_by_distance(is_peak)", is_peak, torch.bool, 2)
    if is_peak.shape != x.shape or is_peak.device != x.device:
        raise ValueError(f"select_peaks_by_distance: is_peak {tuple(is_peak.shape)} on "
                         f"{is_peak.device} does not match x {tuple(x.shape)} on {x.device}")
    if n > K9_MAX_LENGTH:
        raise ValueError(f"select_peaks_by_distance: the CUDA kernel takes rows of at most "
                         f"{K9_MAX_LENGTH} positions; got {n}")
    out = torch.empty_like(is_peak)
    if R == 0 or n == 0:
        return out
    steps = min(max(int(max_peaks), 0), n)
    lib = _kernels.build()
    with torch.cuda.device(x.device):
        err = lib.lib.apt_select_peaks_by_distance(
            x.data_ptr(), is_peak.data_ptr(), out.data_ptr(), R, n,
            min(max(int(distance), 0), n), steps, _kernels.stream_of(x))
    lib.check(err, "select_peaks_by_distance")
    _kernels.count("select_peaks_by_distance")
    return out


def select_peaks_by_distance(x: torch.Tensor, is_peak: torch.Tensor, distance: int,
                             max_peaks: int = 64) -> torch.Tensor:
    """scipy's distance filter as the JAX package bounds it
    (``ops/peaks.py:185-208``) on every row of ``x`` (..., n): the tallest
    remaining peak keeps its place and clears the others strictly closer
    than ``distance``, for the ``max_peaks`` first positions in order only
    (the cap is part of the function).  Returns ``keep & is_peak``.  Kernel
    K9 on a CUDA tensor, the plain loop on a CPU tensor; both give the JAX
    loop's bits."""
    lead, n = x.shape[:-1], x.shape[-1]
    xr = x.to(torch.float32).reshape(-1, n).contiguous()
    pr = is_peak.to(torch.bool).reshape(-1, n).contiguous()
    if x.device.type == "cpu":
        out = _select_peaks_by_distance_plain(xr, pr, int(distance), int(max_peaks))
    else:
        out = _select_peaks_by_distance_cuda(xr, pr, int(distance), int(max_peaks))
    return out.reshape(lead + (n,))
