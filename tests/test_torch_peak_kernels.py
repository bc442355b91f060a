"""Kernels K11-K13 (``csrc/peak_shape.cu``: ``local_maxima``,
``peak_prominences``, ``peak_widths_rel``), which run only on the card,
modelled in NumPy the way the CUDA source does the work, against the JAX
package's functions and the port's plain versions on the CPU.

  * K11's lane route: a lane scans its row from the left, carrying the last
    change boundary and its direction, writes each position 0 at its step
    and marks a rise-to-fall plateau's midpoint, behind the step, when the
    change that closes it comes;
  * K11's warp route: the change boundaries encoded ``j * 2 + up`` as the
    JAX function encodes them, an exclusive running max scanned chunk by
    chunk with a carry, and at each fall boundary the midpoint of the
    plateau its entering rise opened;
  * K12's lane route: two lanes a row, one for each side, jump pointers to
    the previous (or next) strictly higher sample, each carrying its
    segment's NaN-propagating minimum, a NaN passing nothing;
  * K12's table route: range tables of maxima (NaN read as lowest) and
    NaN-propagating minima, a lane a peak descending them to each side's
    nearest strictly higher sample, each base two overlapping entries;
  * K12's walk route: a lane a peak walking each side to the first strictly
    higher sample, the side's minimum and the larger base NaN-propagating;
  * K13: a lane a peak walking each side to the first sample at or below
    ``x[p] - rel_height * prom[p]`` (product, then difference, float32),
    picked samples + 0.0, IEEE division; the walk route takes a row's peaks
    32 at a time, the lane route a tile of 32 rows' peaks, queued by one
    ballot a position across the tile.

Tolerances: K11 and K12 exactly (``assert_array_equal``: values, NaN in the
same places; a zero's sign is not compared, csrc/peak_shape.cu says why),
K13 within the 1e-6 that ``tests/test_torch_peaks.py`` allows the port's
plain version against JAX, and every model exactly against the plain
version (K13's bit for bit but NaN payloads).  Rows:
``chip_smoke.peak_edge_rows`` (plateaus at the borders and across chunks,
constant and monotone rows, NaN, +-inf and +-0) at n = 1, 2, 3, 33, 71,
129, 384 and 1,025, with the local maxima, every position, no position and
a random mask as peaks.  The lane routes' two layouts (rows, and rows as
columns of a transposed view) are checked as the kernel addresses them,
K13's mask as the aligned words that hold its bytes.
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_processing_tools_tpu.ops import peaks as jpk

from chip_smoke import peak_edge_rows

from audio_processing_tools_tpu_torch import _kernels
from audio_processing_tools_tpu_torch.ops import peaks as tpk

CSRC = Path(tpk.__file__).resolve().parent.parent / "csrc"
SIZES = (1, 2, 3, 33, 71, 129, 384, 1025)
K11_CHUNK = 128  # csrc/peak_shape.cu: kChunk, positions a warp scans at a time
K13_TILE = 32  # csrc/peak_shape.cu: rows of a warp's tile in K13's lane route
# the JAX functions jitted, as the JAX package's pipelines run them
JAX_LOCAL_MAXIMA = jax.jit(jpk.local_maxima)
JAX_PROMINENCES = jax.jit(jpk.peak_prominences)
JAX_WIDTHS = jax.jit(jpk.peak_widths_rel, static_argnums=3)


def k11_model(x):
    """K11 on rows ``x`` (R, n): chunk by chunk from the left, the codes of
    the chunk's boundaries j <= n - 2 (``j * 2 + up`` where ``x[j + 1] !=
    x[j]``, else -1), their exclusive running max after the carry, and a
    mark at ``((code >> 1) + 1 + j) >> 1`` for each fall boundary j whose
    running code is a rise."""
    R, n = x.shape
    out = np.zeros((R, n), bool)
    carry = np.full(R, -1, np.int64)
    for base in range(0, n - 1 if n >= 3 else 0, K11_CHUNK):
        j = np.arange(base, min(base + K11_CHUNK, n - 1))
        a, b = x[:, j], x[:, j + 1]
        code = np.where(b != a, 2 * j + (b > a), -1)
        incl = np.maximum.accumulate(code, axis=1)
        run = np.maximum(np.concatenate([np.full((R, 1), -1), incl[:, :-1]], axis=1),
                         carry[:, None])
        r, k = np.nonzero((b < a) & (run >= 0) & (run & 1 == 1))
        out[r, ((run[r, k] >> 1) + 1 + j[k]) >> 1] = True
        carry = np.maximum(carry, incl[:, -1])
    return out


def k11_lane_model(x):
    """K11's lane route on rows ``x`` (R, n), the rows in lockstep as the
    lanes of a warp: at each position f from the left a row writes f as 0,
    and where the change at boundary f - 1 closes a plateau entered by a
    rise and left by a fall (the last change boundary ``c`` rose) it marks
    ``(c + f) >> 1``, behind the step; ``c`` and whether it rose are
    carried."""
    R, n = x.shape
    out = np.zeros((R, n), bool)
    if n == 0:
        return out
    rows = np.arange(R)
    prev, c, rise = x[:, 0], np.full(R, -1), np.zeros(R, bool)
    for f in range(1, n):
        v = x[:, f]
        with np.errstate(invalid="ignore"):
            chg, up, down = v != prev, v > prev, v < prev
        mark = chg & rise & down
        mid = (c + f) >> 1
        assert (mid[mark] < f).all()  # behind the step, never overwritten
        out[rows[mark], mid[mark]] = True
        c = np.where(chg, f - 1, c)
        rise = np.where(chg, up, rise)
        prev = v
    return out


def _nan_min(a, b):
    return np.where(np.isnan(b) | (b < a), b, a)


def _nan_max(a, b):
    return np.where(np.isnan(a), a, np.where(np.isnan(b) | (b > a), b, a))


def _walk(x, r, p, side, stop):
    """The lanes' walks from each peak ``(r, p)`` in direction ``side``, one
    step at a time together: yields ``(live, v, j)`` for the lanes still
    walking, where ``stop(v)`` has not yet held."""
    n = x.shape[1]
    live = np.ones(r.size, bool)
    for k in range(1, n):
        j = p + side * k
        live &= (j >= 0) & (j < n)
        if not live.any():
            return
        v = x[r, np.clip(j, 0, n - 1)]
        hit = live & stop(v)
        yield live & ~hit, hit, v, j
        live &= ~hit


def k12_model(x, is_peak):
    """K12: each peak's sides walked to the first strictly higher sample,
    the bases their NaN-propagating minima (p included, ties keep the
    nearer), the prominence ``x[p] - nan_max(bases)``; +0.0 elsewhere."""
    out = np.zeros(x.shape, np.float32)
    r, p = np.nonzero(is_peak)
    xp = x[r, p]
    bases = []
    for side in (-1, 1):
        base = xp.copy()
        with np.errstate(invalid="ignore"):
            for go, _, v, _ in _walk(x, r, p, side, lambda v: v > xp):
                base[go] = _nan_min(base[go], v[go])
        bases.append(base)
    with np.errstate(invalid="ignore"):
        out[r, p] = xp - _nan_max(*bases)
    return out


def _k12_side(xr, side):
    """One lane of K12's lane route: the row ``xr`` settled from the left
    (side 0) or the right (side 1) in steps that either pass the chain's
    top j (x[i] not NaN and x[j] not strictly higher: merge j's base, go
    to the position j points to) or settle i (its base and pointer, then
    the next position).  Returns the bases."""
    n = xr.size
    d, none = (1, -1) if side == 0 else (-1, n)
    base = np.zeros(n, np.float32)
    ptr = np.full(n, none)
    i = 0 if side == 0 else n - 1
    j = none
    cur = xr[i] if n else None
    while 0 <= i < n:
        if j != none and not np.isnan(xr[i]) and not xr[j] > xr[i]:
            cur, j = _nan_min(cur, base[j]), ptr[j]
        else:
            base[i], ptr[i], j = cur, j, i
            i += d
            cur = xr[i] if 0 <= i < n else None
    return base


def k12_lane_model(x, is_peak):
    """K12's lane route: two lanes a row, one for each side (:func:`_k12_side`),
    then ``x[p] - nan_max(left, right)`` at the peaks, +0.0 elsewhere."""
    out = np.zeros(x.shape, np.float32)
    with np.errstate(invalid="ignore"):
        for r in range(x.shape[0]):
            left, right = _k12_side(x[r], 0), _k12_side(x[r], 1)
            p = np.nonzero(is_peak[r])[0]
            out[r, p] = x[r, p] - _nan_max(left[p], right[p])
    return out


def _levels(n):
    """The table route's levels: the largest k with 2^k <= n."""
    return max(n.bit_length() - 1, 0)


def k12_table_model(x, is_peak):
    """K12's table route: maxima over [i, i + 2^k) with NaN read as lowest
    (``fmaxf``) and NaN-propagating minima, levels 1..floor(log2 n); each
    peak descends both sides a level at a time while the next block holds
    nothing strictly higher, and reads each base as two overlapping
    minima."""
    R, n = x.shape
    K = _levels(n)
    mx, mn = [x], [x]
    for k in range(1, K + 1):
        h, m = 1 << (k - 1), n - (1 << k) + 1
        mx.append(np.fmax(mx[-1][:, :m], mx[-1][:, h : h + m]))
        mn.append(_nan_min(mn[-1][:, :m], mn[-1][:, h : h + m]))
    out = np.zeros(x.shape, np.float32)
    r, p = np.nonzero(is_peak)
    xp = x[r, p]
    a, e = p.copy(), p.copy()
    with np.errstate(invalid="ignore"):
        for k in range(K, -1, -1):
            s = 1 << k
            ok = a - s >= 0
            go = ok & ~(mx[k][r, np.where(ok, a - s, 0)] > xp)
            a = np.where(go, a - s, a)
            ok = e + s <= n - 1
            go = ok & ~(mx[k][r, np.where(ok, e + 1, 0)] > xp)
            e = np.where(go, e + s, e)

        def range_min(lo, hi):
            k = np.floor(np.log2(hi - lo + 1)).astype(np.int64) if lo.size else lo
            got = np.empty(lo.shape, np.float32)
            for kk in np.unique(k):
                at = k == kk
                got[at] = _nan_min(mn[kk][r[at], lo[at]], mn[kk][r[at], hi[at] - (1 << kk) + 1])
            return got

        out[r, p] = xp - _nan_max(range_min(a, p), range_min(p, e))
    return out


def _k13_crossings(x, r, il, ir, h):
    """K13's widths of the peaks on rows ``r`` at heights ``h`` whose walks
    ended at ``il`` (the last j < p with x[j] <= h, else -1) and ``ir`` (the
    first j > p, else n): each crossing interpolated in the plain version's
    order, picked samples + 0.0."""
    n = x.shape[1]
    zero = np.float32(0.0)
    with np.errstate(invalid="ignore", over="ignore", divide="ignore"):
        a = x[r, np.maximum(il, 0)] + zero
        b = x[r, np.minimum(il + 1, n - 1)] + zero
        t = np.where(a < h, (h - a) / np.where(b != a, b - a, np.float32(1.0)), zero)
        left = np.where(il >= 0, il.astype(np.float32) + t, zero)
        a = x[r, np.minimum(ir, n - 1)] + zero
        b = x[r, np.maximum(ir - 1, 0)] + zero
        t = np.where(a < h, (h - a) / np.where(b != a, b - a, np.float32(1.0)), zero)
        right = np.where(ir < n, ir.astype(np.float32) - t, np.float32(n - 1))
        return right - left


def k13_model(x, is_peak, prom, rel_height):
    """K13's walk route: ``h = x[p] - rel * prom[p]`` in float32, the last
    sample at or below h left of p and the first right of p found by walks,
    each crossing interpolated in the plain version's order; +0.0
    elsewhere."""
    n = x.shape[1]
    out = np.zeros(x.shape, np.float32)
    r, p = np.nonzero(is_peak)
    with np.errstate(invalid="ignore", over="ignore"):
        h = x[r, p] - np.float32(rel_height) * prom[r, p]
        found = {}
        for side in (-1, 1):
            at = np.full(r.size, -1 if side < 0 else n)
            for _, hit, _, j in _walk(x, r, p, side, lambda v: v <= h):
                at[hit] = j[hit]
            found[side] = at
    out[r, p] = _k13_crossings(x, r, found[-1], found[1], h)
    return out


def _lane_side(x, r, j, step, h):
    """The lanes' walks from ``j`` in direction ``step`` while ``x[r, j] <=
    h`` does not hold (a NaN sample or a NaN h never stops one), each to
    its first stop or one past the border."""
    n = x.shape[1]
    j = j.copy()
    live = (j >= 0) & (j < n)
    while live.any():
        with np.errstate(invalid="ignore"):
            go = live & ~(x[r, np.clip(j, 0, n - 1)] <= h)
        j[go] += step
        live = go & (j >= 0) & (j < n)
    return j


def k13_lane_model(x, is_peak, prom, rel_height):
    """K13's lane route on rows ``x`` (R, n), the columns of one batch
    entry (T = R): tiles of 32 neighbouring rows; in each, every row's
    peaks counted, an exclusive scan of the counts across the tile placing
    row q's peaks (``f * 32 + q``, positions in order) in the tile's list,
    which is taken a chunk of ``6 n`` entries at a time (the mask's words
    hold it), the
    lanes taking entries ``c0 + lane``, ``c0 + lane + 32``, ...  A lane's
    peak: ``h = x[p] - rel * prom[p]``, both sides walked together to the
    last j < p and the first j > p with x[j] <= h, each crossing
    interpolated (the lanes are modelled together: a peak's width reads
    nothing another lane writes).  Every peak is taken once; +0.0
    elsewhere."""
    R, n = x.shape
    out = np.zeros(x.shape, np.float32)
    cap = 6 * n
    taken = []
    for g in range(0, R, K13_TILE):
        tile = is_peak[g : g + K13_TILE]
        counts = tile.sum(axis=1)
        first = np.concatenate([[0], np.cumsum(counts)[:-1]])
        codes = np.empty(int(counts.sum()), np.int64)
        for q in range(tile.shape[0]):
            codes[first[q] : first[q] + counts[q]] = np.nonzero(tile[q])[0] * 32 + q
        for c0 in range(0, codes.size, cap):
            chunk = codes[c0 : c0 + cap]
            for lane in range(32):
                taken += [(g + (c & 31), c >> 5) for c in chunk[lane::32]]
    r, p = (np.asarray(v, np.int64) for v in zip(*taken)) if taken else (np.zeros(0, np.int64),) * 2
    count = np.zeros(x.shape, np.int64)
    np.add.at(count, (r, p), 1)
    np.testing.assert_array_equal(count, is_peak.astype(np.int64))  # each peak once
    with np.errstate(invalid="ignore", over="ignore"):
        h = x[r, p] - np.float32(rel_height) * prom[r, p]
    il = _lane_side(x, r, p - 1, -1, h)
    ir = _lane_side(x, r, p + 1, 1, h)
    out[r, p] = _k13_crossings(x, r, il, ir, h)
    return out


def _masks(x, seed):
    """Peak masks over rows ``x``: the local maxima, every position, no
    position and a random 30%."""
    rng = np.random.default_rng(seed)
    return {"local maxima": k11_model(x), "every position": np.ones(x.shape, bool),
            "no position": np.zeros(x.shape, bool), "random": rng.random(x.shape) < 0.3}


@pytest.mark.parametrize("n", SIZES)
def test_k11_model_matches_jax_and_plain(n):
    x = peak_edge_rows(n)
    got = k11_model(x)
    np.testing.assert_array_equal(got, np.asarray(JAX_LOCAL_MAXIMA(jnp.asarray(x))))
    np.testing.assert_array_equal(got, tpk._local_maxima_plain(torch.from_numpy(x)).numpy())
    if n == 1025:  # the plateau longer than a chunk marks its midpoint, in an earlier chunk
        assert got[5, (205 + 716) // 2] and got[5, 205:717].sum() == 1


@pytest.mark.parametrize("n", SIZES)
def test_k12_model_matches_jax_and_plain(n):
    x = peak_edge_rows(n)
    for label, mask in _masks(x, n).items():
        got = k12_model(x, mask)
        ref = np.asarray(JAX_PROMINENCES(jnp.asarray(x), jnp.asarray(mask)))
        np.testing.assert_array_equal(got, ref, err_msg=f"{label}, against JAX")
        plain = tpk._peak_prominences_plain(torch.from_numpy(x), torch.from_numpy(mask))
        np.testing.assert_array_equal(got, plain.numpy(), err_msg=f"{label}, against plain")
        assert not np.signbit(got[~mask]).any()  # +0.0 off the peaks


@pytest.mark.parametrize("n", SIZES)
def test_k11_lane_model_matches_jax_and_plain(n):
    x = peak_edge_rows(n)
    got = k11_lane_model(x) if n >= 3 else np.zeros(x.shape, bool)  # n < 3 launches nothing
    np.testing.assert_array_equal(got, np.asarray(JAX_LOCAL_MAXIMA(jnp.asarray(x))))
    np.testing.assert_array_equal(got, tpk._local_maxima_plain(torch.from_numpy(x)).numpy())
    np.testing.assert_array_equal(got, k11_model(x))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("route", ("lane", "table"))
def test_k12_route_models_match_jax_and_plain(route, n):
    x = peak_edge_rows(n)
    model = {"lane": k12_lane_model, "table": k12_table_model}[route]
    for label, mask in _masks(x, n).items():
        got = model(x, mask)
        ref = np.asarray(JAX_PROMINENCES(jnp.asarray(x), jnp.asarray(mask)))
        np.testing.assert_array_equal(got, ref, err_msg=f"{label}, against JAX")
        plain = tpk._peak_prominences_plain(torch.from_numpy(x), torch.from_numpy(mask))
        np.testing.assert_array_equal(got, plain.numpy(), err_msg=f"{label}, against plain")
        assert not np.signbit(got[~mask]).any()  # +0.0 off the peaks


def _lane_rows(flat, rows, n, T):
    """The rows a lane route reads from memory ``flat`` (one dimension) as
    the kernel addresses them (``tile_of``): warp tiles of 32 rows, in
    columns 32 neighbouring rows of one b at ``b n T + t``, positions of
    stride T; in rows 32 consecutive rows at ``r n``."""
    got = np.full((rows, n), np.nan, np.float32)
    per_b = -(-T // 32) if T else 0
    tiles = rows // T * per_b if T else -(-rows // 32)
    for g in range(tiles):
        for lane in range(32):
            if T:
                b, t0 = divmod(g, per_b)
                t = t0 * 32 + lane
                if t < T:
                    got[b * T + t] = flat[b * n * T + t + np.arange(n) * T]
            elif g * 32 + lane < rows:
                r = g * 32 + lane
                got[r] = flat[r * n + np.arange(n)]
    return got


def _k13_mask(mem, off, rows, n, T):
    """The mask K13's lane route reads from bytes ``mem`` (an aligned
    allocation, the mask's element 0 at byte ``off``) of rows as columns:
    a warp tile's aligned 4-byte words that hold its bytes, nine a position
    (its 32 rows' bytes wherever they start), and each row's byte at its
    place in them (``width_lane``)."""
    got = np.zeros((rows, n), bool)
    per_b = -(-T // K13_TILE)
    for g in range(rows // T * per_b):
        b, t0 = divmod(g, per_b)
        base, cnt, row0 = b * n * T + t0 * 32, min(32, T - t0 * 32), b * T + t0 * 32
        smem = np.zeros(36 * n, np.uint8)  # the launcher's bytes for the words
        a0 = off + base
        for e in range(9 * n):
            f = e // 9
            a = a0 + f * T
            w = (a & ~3) + 4 * (e - 9 * f)
            if w < a + cnt:
                smem[4 * e : 4 * e + 4] = mem[w : w + 4]
        for q in range(cnt):
            for f in range(n):
                got[row0 + q, f] = smem[36 * f + ((a0 + f * T) & 3) + q] != 0
    return got


@pytest.mark.parametrize("shape", ((3, 71, 45), (2, 129, 33), (1, 5, 40), (40, 7)))
def test_lane_routes_address_both_layouts(shape):
    """A transposed view is read in place as columns (a partial last tile
    included), a contiguous tensor as rows (K12's lane route), any other
    layout copied; the kernel's addresses give the view's rows, K13's mask
    too from the words that hold its bytes at every offset."""
    base = torch.from_numpy(np.random.default_rng(len(shape)).random(shape, dtype=np.float32))
    view = base.transpose(-1, -2)  # (..., T, n), positions of stride T
    n, T = view.shape[-1], view.shape[-2]
    rows = view.numel() // n
    assert tpk.peak_layout(view) == ("columns" if T > 1 else "rows")
    assert tpk.peak_layout(view.contiguous()) == "rows"
    assert tpk.peak_layout(view[..., ::2]) == "other"
    flat = base.reshape(-1).numpy()  # the view's memory
    want = view.reshape(rows, n).numpy()
    np.testing.assert_array_equal(_lane_rows(flat, rows, n, T), want)
    np.testing.assert_array_equal(_lane_rows(view.contiguous().reshape(-1).numpy(), rows, n, 0),
                                  want)
    out = tpk._like_columns(view, view.shape, torch.bool)  # the outputs keep the view's layout
    assert out.shape == view.shape and out.stride() == view.stride()
    mask = np.random.default_rng(n).random(shape) < 0.3  # K13's mask, in the view's memory
    want = mask.swapaxes(-1, -2).reshape(rows, n)
    for off in range(4):
        mem = np.zeros(off + mask.size + 4, np.uint8)  # 4 bytes past: a word's tail
        mem[off : off + mask.size] = mask.reshape(-1)
        np.testing.assert_array_equal(_k13_mask(mem, off, rows, n, T), want)


@pytest.mark.parametrize("n", (3, 71, 129, 384))
def test_strided_views_give_their_copies_results(n):
    """On the CPU the wrappers take the plain versions; a transposed view
    gives what its contiguous copy gives, and the NumPy models of the lane
    routes agree; K13 with the mask and prominences in the view's layout,
    as the peak gate passes them."""
    rows = peak_edge_rows(n)
    view = torch.from_numpy(np.ascontiguousarray(rows.T)).transpose(-1, -2)
    dense = view.contiguous()
    mask = tpk.local_maxima(view)
    assert torch.equal(mask, tpk.local_maxima(dense))
    np.testing.assert_array_equal(mask.numpy(), k11_lane_model(rows))
    prom = tpk.peak_prominences(view, mask)
    np.testing.assert_array_equal(prom.numpy(), tpk.peak_prominences(dense, mask).numpy())
    np.testing.assert_array_equal(prom.numpy(), k12_lane_model(rows, mask.numpy()))
    mask_c = tpk._like_columns(view, view.shape, torch.bool).copy_(mask)
    prom_c = tpk._like_columns(view, view.shape, torch.float32).copy_(prom)
    assert {tpk.peak_layout(t) for t in (view, mask_c, prom_c)} == {"columns"}
    width = tpk.peak_widths_rel(view, mask_c, prom_c, 0.5)
    dense_width = tpk.peak_widths_rel(dense, mask.contiguous(), prom.contiguous(), 0.5).numpy()
    np.testing.assert_array_equal(width.numpy().view(np.int32), dense_width.view(np.int32))
    lane = k13_lane_model(rows, mask.numpy(), prom.numpy(), 0.5)
    nan = np.isnan(lane)
    np.testing.assert_array_equal(nan, np.isnan(dense_width))
    np.testing.assert_array_equal(lane.view(np.int32)[~nan], dense_width.view(np.int32)[~nan])


@functools.lru_cache(maxsize=None)
def _k13_cases(n, rel_height):
    """K13's cases on the edge rows of ``n``: ``{mask label: (mask,
    prominences, the jitted JAX function's widths, the plain version's)}``,
    computed once for both routes' models."""
    x = peak_edge_rows(n)
    cases = {}
    for label, mask in _masks(x, n + 1).items():
        prom = k12_model(x, mask)
        ref = np.asarray(JAX_WIDTHS(jnp.asarray(x), jnp.asarray(mask), jnp.asarray(prom),
                                    rel_height))
        plain = tpk._peak_widths_rel_plain(torch.from_numpy(x), torch.from_numpy(mask),
                                           torch.from_numpy(prom), rel_height).numpy()
        cases[label] = (mask, prom, ref, plain)
    return cases


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("rel_height", (0.5, 1.0))
@pytest.mark.parametrize("route", ("walk", "lane"))
def test_k13_model_matches_jax_and_plain(route, rel_height, n):
    x = peak_edge_rows(n)
    model = {"walk": k13_model, "lane": k13_lane_model}[route]
    for label, (mask, prom, ref, plain) in _k13_cases(n, rel_height).items():
        got = model(x, mask, prom, rel_height)
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6, err_msg=f"{label}, JAX")
        nan = np.isnan(got)  # NaN in the same places, every other value's bits
        np.testing.assert_array_equal(nan, np.isnan(plain), err_msg=f"{label}, NaN")
        np.testing.assert_array_equal(got.view(np.int32)[~nan], plain.view(np.int32)[~nan],
                                      err_msg=f"{label}, against plain, bit for bit")


@pytest.mark.parametrize("n", (3, 33, 71))
def test_k13_lane_model_takes_a_long_list_in_chunks(n):
    """A tile whose peaks outgrow the mask's words (every position of 40
    rows: 32 n peaks in the first tile, more than ``6 n``) is taken a chunk
    at a time and still gives the plain version's bits."""
    rows = np.random.default_rng(n).standard_normal((40, n)).astype(np.float32)
    rows[3, ::4] = rows[3, 0]  # ties
    mask = np.ones(rows.shape, bool)
    assert 32 * n > 6 * n
    prom = k12_model(rows, mask)
    got = k13_lane_model(rows, mask, prom, 0.5)
    plain = tpk._peak_widths_rel_plain(torch.from_numpy(rows), torch.from_numpy(mask),
                                       torch.from_numpy(prom), 0.5).numpy()
    np.testing.assert_array_equal(got.view(np.int32), plain.view(np.int32))


def test_peak_shape_route_follows_the_source():
    src = (CSRC / "peak_shape.cu").read_text()
    assert f"constexpr int kSharedMax = {tpk.PEAK_SHAPE_SHARED_MAX};" in src
    assert f"constexpr int kLaneMax11 = {tpk.K11_LANE_MAX};" in src
    assert f"constexpr int kLaneMax12 = {tpk.K12_LANE_MAX};" in src
    assert f"constexpr int kLaneMax13 = {tpk.K13_LANE_MAX};" in src
    # K13's lane route: two buffers, each x at 33 floats a position, then
    # the mask's words (the list of peaks after them), a warp's shared
    # memory within the card's 227 KB; a row's peaks as bits in 32-bit words
    assert "constexpr int kPitch13 = 33;" in src
    assert ("return 2 * (size_t)(kPitch13 + 9) * m * sizeof(float);" in src
            and "const size_t smem = smem_of(n);" in src)
    assert "const int per = (kPitch13 + 9) * n;" in src  # the same buffer, in floats
    assert "const int cap = 6 * n;" in src  # k13_lane_model's chunk: 4 + 2 bytes an entry
    assert 2 * (33 + 9) * 4 * tpk.K13_LANE_MAX <= 227 * 1024
    assert tpk.K13_LANE_MAX % 32 == 0 and "uint32_t bits[kLaneMax13 / 32];" in src
    assert 32 * 16 * tpk.K12_LANE_MAX <= 227 * 1024  # a warp's records in shared memory
    assert "constexpr int kChunk = 32 * kPer;" in src and "constexpr int kPer = 4;" in src
    assert K11_CHUNK == 32 * 4
    # K13's lane route reads columns in place; contiguous rows, and columns
    # past it, take the walk from device memory
    assert tpk.width_route(71, "columns") == tpk.width_route(1, "columns") == "lane"
    assert tpk.width_route(tpk.K13_LANE_MAX, "columns") == "lane"
    assert tpk.width_route(tpk.K13_LANE_MAX + 1, "columns") == tpk.width_route(2048) == "walk"
    assert tpk.width_route(71) == tpk.width_route(71, "other") == "walk"
    assert tpk.width_route(2049, "columns") == tpk.width_route(30000) == "walk"
    # K11's lane route reads columns in place; contiguous rows take the warp route
    assert tpk.local_maxima_route(3, "columns") == "lane"
    assert tpk.local_maxima_route(tpk.K11_LANE_MAX, "columns") == "lane"
    assert tpk.local_maxima_route(tpk.K11_LANE_MAX + 1, "columns") == "warp"
    assert tpk.local_maxima_route(71) == tpk.local_maxima_route(176, "rows") == "warp"
    assert tpk.local_maxima_route(71, "other") == "warp"
    assert tpk.prominence_route(1) == tpk.prominence_route(tpk.K12_LANE_MAX) == "lane"
    assert tpk.prominence_route(256) == tpk.prominence_route(2048) == "table"
    assert tpk.prominence_route(2049) == "walk"
    # the route codes the entry points take, in the order their comments give
    assert "route 0 a lane a row (rows as columns, T > 0, n <=\n// kLaneMax11), 1 a warp a row" in src
    assert tpk._K11_ROUTES == {"lane": 0, "warp": 1}
    assert "route 0 two lanes a row (n <= kLaneMax12), 1 the range" in src
    assert tpk._K12_ROUTES == {"lane": 0, "table": 1, "walk": 2}
    assert ("route 0 a lane a peak\n// of a warp's tile of 32 rows (rows as columns, T > 0, n "
            "<= kLaneMax13), 1\n// the walks from device memory (contiguous rows, T = 0)") in src
    assert tpk._K13_ROUTES == {"lane": 0, "walk": 1}
    for name in ("apt_local_maxima", "apt_peak_prominences", "apt_peak_widths_rel"):
        assert f'extern "C" int {name}(' in src and name in _kernels._SIGNATURES
    for name in ("local_maxima", "peak_prominences", "peak_widths_rel"):
        assert name in _kernels.LAUNCHES


@pytest.mark.parametrize("kernel", ("local_maxima", "peak_prominences", "peak_widths_rel"))
def test_cuda_wrappers_refuse_a_cpu_tensor(kernel):
    x = torch.from_numpy(peak_edge_rows(33))
    mask = torch.ones(x.shape, dtype=torch.bool)
    args = {"local_maxima": (x,), "peak_prominences": (x, mask),
            "peak_widths_rel": (x, mask, torch.zeros_like(x), 0.5)}[kernel]
    with pytest.raises(ValueError, match="CUDA tensor"):
        getattr(tpk, f"_{kernel}_cuda")(*args)


def test_cpu_tensors_take_the_plain_versions():
    x = torch.from_numpy(peak_edge_rows(129)).reshape(13, 3, 43)
    _kernels.reset_launches()
    mask = tpk.local_maxima(x)
    prom = tpk.peak_prominences(x, mask)
    width = tpk.peak_widths_rel(x, mask, prom, 0.5)
    assert not any(_kernels.LAUNCHES.values())  # the CPU runs no kernel
    assert torch.equal(mask, tpk._local_maxima_plain(x))
    np.testing.assert_array_equal(prom.numpy(), tpk._peak_prominences_plain(x, mask).numpy())
    np.testing.assert_array_equal(width.numpy(),
                                  tpk._peak_widths_rel_plain(x, mask, prom, 0.5).numpy())
    np.testing.assert_array_equal(mask.numpy(), k11_model(x.reshape(-1, 43).numpy()).reshape(
        x.shape))
