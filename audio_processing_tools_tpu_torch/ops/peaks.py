"""Peak detection along the last axis as fixed-shape masks, batched.

Counterpart of ``audio_processing_tools_tpu/ops/peaks.py``:
:func:`local_maxima` (``:27-71``), :func:`peak_prominences` (``:74-105``)
and :func:`peak_widths_rel` (``:108-163``), whose XLA-fused programs are
kernels K11-K13 on the card (``csrc/peak_shape.cu``), and
:func:`select_peaks_by_distance` (``:185-208``), the stage-2 confirmer's
distance filter, whose ``fori_loop`` is kernel K9 (``csrc/peaks.cu``).  On
a CPU tensor each takes its plain version, the JAX package's own form:
``torch.cummax`` for ``lax.cummax`` (its ``reverse=True`` through
``flip``) and the masked O(N^2) planes.  :func:`find_peaks`
(``:166-182``) is the masked ``find_peaks`` over the first two; nothing in
the JAX package calls it.
"""

from __future__ import annotations

import torch

from audio_processing_tools_tpu_torch import _kernels

# csrc/peak_shape.cu's route lengths: kSharedMax (K12's table route, K12's
# walks in shared memory), kLaneMax11, kLaneMax12, kLaneMax13 (a lane a
# row, K12's a lane a side, K13's a lane a peak of a 32-row tile)
PEAK_SHAPE_SHARED_MAX = 2048
K11_LANE_MAX = 256
K12_LANE_MAX = 255
K13_LANE_MAX = 160
_K11_ROUTES = {"lane": 0, "warp": 1}
_K12_ROUTES = {"lane": 0, "table": 1, "walk": 2}
_K13_ROUTES = {"lane": 0, "walk": 1}


def width_route(n: int, layout: str = "rows") -> str:
    """K13's route for rows of ``n`` positions in ``layout``
    (:func:`peak_layout`): ``"lane"`` (persistent warps, a tile of 32 rows
    at a time, a lane a peak) for columns up to :data:`K13_LANE_MAX`, read
    in place; otherwise ``"walk"``, a warp a row on contiguous rows read
    from device memory.  On the card the lane route lost to the walk on
    columns past 129 positions (``PERF.md``)."""
    return "lane" if layout == "columns" and n <= K13_LANE_MAX else "walk"


def local_maxima_route(n: int, layout: str = "rows") -> str:
    """K11's route for rows of ``n`` positions in ``layout``
    (:func:`peak_layout`): ``"lane"`` (a lane scans a row, read in place)
    for columns up to :data:`K11_LANE_MAX`, ``"warp"`` (a warp scans a
    contiguous row in chunks) otherwise; on the card a lane a contiguous
    row lost to the warp route at every path's shape (``PERF.md``)."""
    return "lane" if layout == "columns" and n <= K11_LANE_MAX else "warp"


def prominence_route(n: int) -> str:
    """K12's route for rows of ``n`` positions: ``"lane"`` (two lanes a
    row, one a side, jump pointers) up to :data:`K12_LANE_MAX`, ``"table"`` (a warp
    a row, range tables in shared memory, a lane a peak) up to
    :data:`PEAK_SHAPE_SHARED_MAX`, ``"walk"`` (a lane a peak walking from
    device memory) beyond."""
    if n <= K12_LANE_MAX:
        return "lane"
    return "table" if n <= PEAK_SHAPE_SHARED_MAX else "walk"


def peak_layout(t: torch.Tensor) -> str:
    """How K11-K13's lane routes find the rows of ``t`` (..., n):
    ``"rows"`` where ``t`` is contiguous; ``"columns"`` where its last two
    axes are those of a contiguous (..., n, T) tensor swapped (row (b, t)
    at ``b n T + t``, positions of stride T: the peak gate's
    ``spec.transpose(-1, -2)``, RoE's ``mag.transpose(-1, -2)``); else
    ``"other"``, which the wrappers copy to rows."""
    if t.is_contiguous():
        return "rows"
    if t.dim() >= 2 and t.transpose(-1, -2).is_contiguous():
        return "columns"
    return "other"


def _like_columns(t: torch.Tensor, shape, dtype) -> torch.Tensor:
    """An empty tensor of ``shape`` (..., T, n) laid out as columns."""
    return torch.empty(tuple(shape[:-2]) + (shape[-1], shape[-2]), dtype=dtype,
                       device=t.device).transpose(-1, -2)


def _lane_input(name: str, x: torch.Tensor, dtype, lane: bool):
    """``(x, T)`` as K11-K13 read ``x`` (..., n) on the card: a lane
    route reads it in place as columns (T its rows a batch entry) or as
    contiguous rows (T = 0); anything else, or another route, gets
    contiguous rows."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got device {x.device}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if lane and peak_layout(x) == "columns":
        return x, x.shape[-2]
    return x.contiguous(), 0


def _local_maxima_plain(x: torch.Tensor) -> torch.Tensor:
    """The JAX formulation on any tensor: each position finds the nearest
    strict change on each side with a running max over encoded boundary
    indices whose low bit carries the change's direction."""
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


def _local_maxima_cuda(x: torch.Tensor, route: str | None = None) -> torch.Tensor:
    """K11 (``csrc/peak_shape.cu``) on float32 ``x`` (..., n): a lane a row
    for columns up to :data:`K11_LANE_MAX` positions, read in place and
    answered in their layout; a warp a row on contiguous rows, other
    layouts copied (:func:`local_maxima_route`; ``route`` forces one).
    Rows shorter than 3 have no maximum and launch nothing."""
    n = x.shape[-1]
    route = route or local_maxima_route(n, peak_layout(x))
    xr, T = _lane_input("local_maxima", x, torch.float32, route == "lane")
    if route == "lane" and not T:
        raise ValueError("local_maxima: the lane route reads rows as columns of a transposed view")
    if x.numel() == 0 or n < 3:
        return torch.zeros_like(x, dtype=torch.bool)
    out = _like_columns(x, x.shape, torch.bool) if T else torch.empty(
        x.shape, dtype=torch.bool, device=x.device)
    lib = _kernels.build()
    with torch.cuda.device(x.device):
        err = lib.lib.apt_local_maxima(xr.data_ptr(), out.data_ptr(), x.numel() // n, n, T,
                                       _K11_ROUTES[route], _kernels.stream_of(x))
    lib.check(err, "local_maxima")
    _kernels.count("local_maxima")
    return out


def local_maxima(x: torch.Tensor) -> torch.Tensor:
    """Boolean mask of local maxima along the last axis, scipy's plateau
    rule included: a plateau marks its midpoint; the first and last samples
    never peak.  Kernel K11 on a CUDA tensor (float32; a transposed view
    is read in place and the mask comes in its layout), the plain version
    on a CPU tensor; both give the JAX function's mask."""
    if x.device.type == "cpu":
        return _local_maxima_plain(x)
    return _local_maxima_cuda(x)


def _peak_prominences_plain(x: torch.Tensor, is_peak: torch.Tensor) -> torch.Tensor:
    """The JAX package's masked O(N^2) form on any tensor."""
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


def _peak_prominences_cuda(x: torch.Tensor, is_peak: torch.Tensor,
                           route: str | None = None) -> torch.Tensor:
    """K12 (``csrc/peak_shape.cu``) on float32 ``x`` (..., n) and a bool
    ``is_peak`` that broadcasts to it: two lanes a row up to
    :data:`K12_LANE_MAX` positions, reading ``x`` as rows or columns in
    place (the mask is copied into ``x``'s layout where it lies otherwise)
    and writing in that layout; range tables up to
    :data:`PEAK_SHAPE_SHARED_MAX`; walks beyond (:func:`prominence_route`;
    ``route`` forces one).  Nothing is launched for an empty input."""
    n = x.shape[-1]
    route = route or prominence_route(n)
    xr, T = _lane_input("peak_prominences", x, torch.float32, route == "lane")
    pk = torch.broadcast_to(is_peak, x.shape)
    if pk.device != x.device:
        raise ValueError(f"peak_prominences: is_peak on {pk.device}, x on {x.device}")
    if pk.dtype != torch.bool:
        raise TypeError(f"peak_prominences(is_peak): expected torch.bool, got {pk.dtype}")
    if T and pk.stride() != xr.stride():
        pk = _like_columns(x, x.shape, torch.bool).copy_(pk)
    elif not T:
        pk = pk.contiguous()
    out = _like_columns(x, x.shape, torch.float32) if T else torch.empty(
        x.shape, dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    lib = _kernels.build()
    with torch.cuda.device(x.device):
        err = lib.lib.apt_peak_prominences(xr.data_ptr(), pk.data_ptr(), out.data_ptr(),
                                           x.numel() // n, n, T, _K12_ROUTES[route],
                                           _kernels.stream_of(x))
    lib.check(err, "peak_prominences")
    _kernels.count("peak_prominences")
    return out


def peak_prominences(x: torch.Tensor, is_peak: torch.Tensor) -> torch.Tensor:
    """Prominence of every position, 0 where ``is_peak`` is false (scipy
    semantics: each side extends to a strictly higher sample or the border,
    its base is the side's minimum, the prominence is the peak less the
    higher base; NaN propagates).  Kernel K12 on a CUDA tensor (float32
    ``x``, bool ``is_peak``; a transposed view of a short row is read in
    place and the result comes in its layout), the plain version on a CPU
    tensor; both give
    the JAX function's values (a zero's sign aside where the plain version's
    minimum ties -0.0 with +0.0, ``csrc/peak_shape.cu``)."""
    if x.device.type == "cpu":
        return _peak_prominences_plain(x, is_peak)
    return _peak_prominences_cuda(x, is_peak)


def find_peaks(x: torch.Tensor, height: torch.Tensor | float | None = None,
               prominence: float | None = None):
    """Masked ``find_peaks`` over the last axis (``ops/peaks.py:166-182``):
    returns ``(is_peak, prominences)``, the prominences 0 off the peaks.

    ``height`` and ``prominence`` filter like scipy's scalar lower bounds.
    The prominences are computed before the height filter only when
    ``prominence`` is given (pass 0.0 to have them without filtering)."""
    mask = local_maxima(x)
    prom = None
    if prominence is not None:
        prom = peak_prominences(x, mask)
        mask = mask & (prom >= prominence)
    if height is not None:
        mask = mask & (x >= height)
    if prom is None:
        prom = peak_prominences(x, mask)
    return mask, torch.where(mask, prom, 0.0)


def _pick_at(xj: torch.Tensor, jj: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx[..., p]]`` per row p, as the JAX package's one-hot sum."""
    return torch.sum(torch.where(jj == idx[..., :, None], xj, 0.0), dim=-1)


def _peak_widths_rel_plain(x: torch.Tensor, is_peak: torch.Tensor,
                           prominences: torch.Tensor, rel_height: float = 0.5) -> torch.Tensor:
    """The JAX package's masked O(N^2) form with one-hot picks, on any tensor."""
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


def _peak_widths_rel_cuda(x: torch.Tensor, is_peak: torch.Tensor, prominences: torch.Tensor,
                          rel_height: float = 0.5, route: str | None = None) -> torch.Tensor:
    """K13 (``csrc/peak_shape.cu``) on float32 ``x`` (..., n) and a bool
    ``is_peak`` and the ``prominences`` that broadcast to it: on columns up
    to :data:`K13_LANE_MAX` positions a warp a tile of 32 rows and a lane a
    peak, reading ``x`` in place (the mask and the prominences are copied
    into ``x``'s layout where they lie otherwise) and writing in that
    layout; otherwise the walks, a warp a row, on contiguous rows, other
    layouts copied (:func:`width_route`; ``route`` forces one).  Each lane
    walks its peak's sides to the first sample at or below its height, the
    plain version's operations in its order; ``rel_height`` is taken as
    float32, as the plain version's scalar product takes it.  Nothing is
    launched for an empty input."""
    n = x.shape[-1]
    route = route or width_route(n, peak_layout(x))
    xr, T = _lane_input("peak_widths_rel", x, torch.float32, route == "lane")
    if route == "lane" and not T:
        raise ValueError("peak_widths_rel: the lane route reads rows as columns of a "
                         "transposed view")
    pk = torch.broadcast_to(is_peak, x.shape)
    pm = torch.broadcast_to(prominences, x.shape)
    if pk.device != x.device or pm.device != x.device:
        raise ValueError(f"peak_widths_rel: is_peak on {pk.device}, prominences on "
                         f"{pm.device}, x on {x.device}")
    if pk.dtype != torch.bool:
        raise TypeError(f"peak_widths_rel(is_peak): expected torch.bool, got {pk.dtype}")
    if pm.dtype != torch.float32:
        raise TypeError(f"peak_widths_rel(prominences): expected torch.float32, got {pm.dtype}")
    if T:
        if pk.stride() != xr.stride():
            pk = _like_columns(x, x.shape, torch.bool).copy_(pk)
        if pm.stride() != xr.stride():
            pm = _like_columns(x, x.shape, torch.float32).copy_(pm)
    else:
        pk, pm = pk.contiguous(), pm.contiguous()
    out = _like_columns(x, x.shape, torch.float32) if T else torch.empty(
        x.shape, dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    lib = _kernels.build()
    with torch.cuda.device(x.device):
        err = lib.lib.apt_peak_widths_rel(xr.data_ptr(), pk.data_ptr(), pm.data_ptr(),
                                          out.data_ptr(), x.numel() // n, n, T,
                                          float(rel_height), _K13_ROUTES[route],
                                          _kernels.stream_of(x))
    lib.check(err, "peak_widths_rel")
    _kernels.count("peak_widths_rel")
    return out


def peak_widths_rel(x: torch.Tensor, is_peak: torch.Tensor,
                    prominences: torch.Tensor, rel_height: float = 0.5) -> torch.Tensor:
    """Width of each peak at ``x[p] - rel_height * prominence``, crossings
    interpolated linearly (scipy ``peak_widths``); 0 where not a peak.
    Kernel K13 on a CUDA tensor (float32 ``x`` and ``prominences``, bool
    ``is_peak``; a transposed view of a short row is read in place and the
    widths come in its layout), the plain version on a CPU tensor, with the
    same bits."""
    if x.device.type == "cpu":
        return _peak_widths_rel_plain(x, is_peak, prominences, rel_height)
    return _peak_widths_rel_cuda(x, is_peak, prominences, rel_height)


K9_MAX_LENGTH = 1024  # csrc/peaks.cu: the warp route's rows, a 32-bit word of covered positions a lane
K9_LONG_SMEM_KEYS = 16384  # csrc/peaks.cu: keys a long row sorts in shared memory
K9_LONG_SMEM_WORDS = 16384  # csrc/peaks.cu: bitmap words a long row keeps in shared memory


def k9_route(n: int) -> str:
    """K9's kernel for rows of ``n`` positions: ``"warp"`` (a warp a row) up
    to :data:`K9_MAX_LENGTH`, ``"block"`` (a block a row, the positions
    sorted by a bitonic network) beyond."""
    return "warp" if n <= K9_MAX_LENGTH else "block"


def k9_long_plan(n: int):
    """The block route's ``(np2, keys in shared memory, bitmap in shared
    memory)`` for rows of ``n``, as ``long_plan`` in the kernel's source: the
    keys sorted (``n`` rounded up to a power of two) and where each array
    lives; what does not fit shared memory lives in device scratch."""
    np2 = 1 << max(n - 1, 0).bit_length()
    return np2, np2 <= K9_LONG_SMEM_KEYS, -(-n // 32) <= K9_LONG_SMEM_WORDS


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
    """K9 (``csrc/peaks.cu``): one warp a row up to :data:`K9_MAX_LENGTH`
    positions, one block a row beyond (:func:`k9_route`).  The loop's step count
    ``min(max_peaks, n)`` is clamped at 0, as ``range`` and ``fori_loop``
    run no step for a negative cap; a distance outside ``[0, n]`` clears
    what its end of that range clears."""
    R, n = x.shape
    _kernels.require_cuda("select_peaks_by_distance", x, torch.float32, 2)
    _kernels.require_cuda("select_peaks_by_distance(is_peak)", is_peak, torch.bool, 2)
    if is_peak.shape != x.shape or is_peak.device != x.device:
        raise ValueError(f"select_peaks_by_distance: is_peak {tuple(is_peak.shape)} on "
                         f"{is_peak.device} does not match x {tuple(x.shape)} on {x.device}")
    out = torch.empty_like(is_peak)
    if R == 0 or n == 0:
        return out
    steps = min(max(int(max_peaks), 0), n)
    d = min(max(int(distance), 0), n)
    lib = _kernels.build()
    with torch.cuda.device(x.device):
        if k9_route(n) == "warp":
            err = lib.lib.apt_select_peaks_by_distance(
                x.data_ptr(), is_peak.data_ptr(), out.data_ptr(), R, n, d, steps,
                _kernels.stream_of(x))
        else:
            np2, keys_shared, bits_shared = k9_long_plan(n)
            keys = None if keys_shared else torch.empty((R, np2), dtype=torch.int64,
                                                        device=x.device)
            bits = None if bits_shared else torch.empty((R, -(-n // 32)), dtype=torch.int32,
                                                        device=x.device)
            err = lib.lib.apt_select_peaks_long(
                x.data_ptr(), is_peak.data_ptr(), out.data_ptr(), R, n, d, steps,
                None if keys is None else keys.data_ptr(),
                None if bits is None else bits.data_ptr(), _kernels.stream_of(x))
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
