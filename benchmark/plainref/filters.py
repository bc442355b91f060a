"""IIR (biquad cascade) filtering, plain PyTorch on the CPU.

Frozen copy of the port's ``ops/filters.py`` (its host design and its CPU
paths): Butterworth design by scipy, ``sosfiltfilt`` as two constant matrix
products per 128-sample block plus a log-depth prefix over block-boundary
states, and ``sosfilt`` from zero state as the sequential-boundary cascade
in which every dot product is a left-to-right sum.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as tnf

from .consts import host


# ---------------------------------------------------------------------------
# Butterworth design (scipy, on the host)
# ---------------------------------------------------------------------------


def butter_sos(order: int, wn, btype: str) -> np.ndarray:
    """Butterworth digital filter in second-order sections, float64:
    ``scipy.signal.butter(order, wn, btype, output="sos")``, whose section
    order and zero pairing the port's design matches."""
    import scipy.signal

    return np.asarray(scipy.signal.butter(order, wn, btype=btype, output="sos"), np.float64)


# ---------------------------------------------------------------------------
# sosfilt / zi  (scipy parity)
# ---------------------------------------------------------------------------


def sosfilt_zi(sos: np.ndarray) -> np.ndarray:
    """Steady-state initial conditions; matches ``scipy.signal.sosfilt_zi``.

    Per section solves the DF2T steady state for unit step input, scaled by
    the cascade's cumulative DC gain.
    """
    sos = np.asarray(sos, dtype=np.float64)
    n_sections = sos.shape[0]
    zi = np.empty((n_sections, 2))
    scale = 1.0
    for s in range(n_sections):
        b = sos[s, :3]
        a = sos[s, 3:]
        # steady state of DF2T: solve (I - A) zss = B for x=1
        a1, a2 = a[1], a[2]
        b0, b1, b2 = b
        A = np.array([[-a1, 1.0], [-a2, 0.0]])
        Bv = np.array([b1 - a1 * b0, b2 - a2 * b0])
        zss = np.linalg.solve(np.eye(2) - A, Bv)
        zi[s] = scale * zss
        scale *= b.sum() / a.sum()
    return zi


def _cascade_state_space(sos: np.ndarray):
    """Combined state-space of a DF2T biquad cascade (float64, host).

    Returns ``(A, Bv, r, d0)`` with state ``s[n] = A s[n-1] + Bv x[n]`` and
    output ``y[n] = d0 x[n] + r . s[n-1]``; the 2S-dim state is the
    concatenation of the per-section DF2T states, so an initial ``s[-1]``
    assembled from per-section ``zi`` reproduces the sequential cascade
    exactly.
    """
    sos = np.asarray(sos, dtype=np.float64)
    S = sos.shape[0]
    A = np.zeros((2 * S, 2 * S))
    Bv = np.zeros(2 * S)
    r = np.zeros(2 * S)
    d0 = 1.0
    for s in range(S):
        b0, b1, b2, _, a1, a2 = sos[s]
        As = np.array([[-a1, 1.0], [-a2, 0.0]])
        Bs = np.array([b1 - a1 * b0, b2 - a2 * b0])
        # section input: u[n] = d0 x[n] + r . s[n-1]
        A[2 * s : 2 * s + 2, :] = np.outer(Bs, r)
        A[2 * s : 2 * s + 2, 2 * s : 2 * s + 2] += As
        Bv[2 * s : 2 * s + 2] = Bs * d0
        # section output: y[n] = b0 u[n] + z_s0[n-1]
        r = b0 * r
        r[2 * s] += 1.0
        d0 *= b0
    return A, Bv, r, d0


def _cascade_matmul_constants(sos: np.ndarray, block: int):
    """Host constants that turn the cascade into two matrix products.

    With in-block index ``i`` and block-start state ``z`` (the state before
    the block's first sample):

        s[i]  = A^{i+1} z + sum_u A^{i-u} Bv x[u]
        y[i]  = d0 x[i] + r . s[i-1]
              = (Zmat[i] . z) + sum_u L[i, u] x[u]

    so the per-sample output is two matmuls against constants built from the
    powers of ``A`` (the matrix prefix of the old blocked scan was
    data-independent — only the drift vector depends on x):

        L[i, u] = d0            if u == i        (direct feedthrough)
                  r . A^{i-1-u} Bv   if u < i    (in-block impulse response)
        Zmat[i] = r . A^i                        (block-start state pickup)
        Kblk[u] = A^{block-1-u} Bv               (block composite drift)
        Ablk    = A^block                        (block composite matrix)

    Everything is computed in float64 and cast at use.  Exact linear algebra
    — no truncation: cross-block history enters through the boundary states.
    """
    A, Bv, r, d0 = _cascade_state_space(sos)
    n = A.shape[0]
    # powers[i] = A^i, i = 0..block
    powers = np.empty((block + 1, n, n))
    powers[0] = np.eye(n)
    for i in range(1, block + 1):
        powers[i] = A @ powers[i - 1]
    # g[d] = r . A^{d-1} Bv  (impulse response tail), d = 1..block-1
    g = np.einsum("s,dst,t->d", r, powers[: block - 1], Bv)
    L = np.zeros((block, block))
    idx = np.arange(block)
    L[idx, idx] = d0
    for d in range(1, block):
        L[idx[d:], idx[d:] - d] = g[d - 1]
    Zmat = r @ powers[:block]                      # (block, n)
    Kblk = powers[block - 1 :: -1] @ Bv            # (block, n): A^{block-1-u} Bv
    return L, Zmat, Kblk, powers[block]


def _boundary_logdepth_powers(sos: np.ndarray, block: int, nb: int):
    """Host ``(A^block)^(2^k)`` ladder (float64) for the log-depth
    boundary prefix, k = 0..ceil(log2(nb))-1 — the boundary recurrence
    steps BLOCKS, so the doubling weights are powers of the block
    composite matrix."""
    A, _, _, _ = _cascade_state_space(sos)
    pows = []
    span = 1
    M = np.linalg.matrix_power(A, block)
    while span < nb:
        pows.append(M)
        M = M @ M
        span *= 2
    return pows


def _sosfilt_cascade_matmul(sos: np.ndarray, x: torch.Tensor,
                            zi: torch.Tensor, block: int = 128,
                            reverse: bool = False) -> torch.Tensor:
    """Whole-cascade ``sosfilt`` over the last axis (y only), the JAX
    package's ``boundary="logdepth"`` form (the ``scan`` form is
    :func:`cascade_sosfilt`).

    With block-start state ``z`` and in-block index ``i`` the output is
    ``y[i] = Zmat[i] . z + sum_u L[i, u] x[u]``: two constant products.  The
    block-start states come from a Hillis-Steele doubling prefix over the
    block composite drifts, weighted by ``(A^block)^(2^k)``.

    ``zi``: (..., n_sections, 2) initial conditions (scipy layout).
    ``reverse=True`` computes ``flip(filter(flip(x)))`` without
    materializing a flip: the in-block constants are rotated by 180 degrees
    and the prefix runs right to left.
    """
    T = x.shape[-1]
    nb = -(-T // block)
    sos = np.asarray(sos, dtype=np.float64)
    S = sos.shape[0]
    lead = x.shape[:-1]
    pad = nb * block - T

    def make():
        L, Zmat, Kblk, _ = _cascade_matmul_constants(sos, block)
        if reverse:
            L, Zmat, Kblk = L[::-1, ::-1], Zmat[::-1], Kblk[::-1]
        return tuple(np.ascontiguousarray(a) for a in (L.T, Zmat.T, Kblk))

    Lt, Zt, Kc = host(make)

    xp = tnf.pad(x, (pad, 0) if reverse else (0, pad))
    xb = xp.reshape(lead + (nb, block))

    # block composite drifts: c[j] = sum_u A^{block-1-u} Bv x[j, u]
    cblk = torch.matmul(xb, Kc)                                 # (..., nb, 2S)
    z0 = zi.to(x.dtype).reshape(zi.shape[:-2] + (2 * S,)).expand(lead + (2 * S,))

    # zstarts[j] = A^j z0 + sum_{u<j} A^{j-1-u} c_u: the inclusive
    # matrix-weighted prefix of d = [z0, c_0, .., c_{nb-2}]
    cb = cblk.flip(-2) if reverse else cblk
    p = torch.cat([z0[..., None, :], cb[..., :-1, :]], dim=-2)
    span = 1
    ladder = host(lambda: tuple(np.ascontiguousarray(Ak.T)
                                for Ak in _boundary_logdepth_powers(sos, block, nb)))
    for AkT in ladder:
        shifted = tnf.pad(p, (0, 0, span, 0))[..., :nb, :]
        p = p + torch.matmul(shifted, AkT)
        span *= 2
    zstarts = p.flip(-2) if reverse else p

    y = torch.matmul(xb, Lt) + torch.matmul(zstarts, Zt)
    y = y.reshape(lead + (nb * block,))
    return y[..., pad:] if reverse else y[..., :T]


# ---------------------------------------------------------------------------
# K4: the cascade with the sequential block boundary
# ---------------------------------------------------------------------------

#: samples per block of the cascade form that kernel K4 takes
K4_BLOCK = 128


def cascade_scan_tables(sos: np.ndarray, block: int, P: int):
    """Host constants of the sequential-boundary cascade, float64 (rounded
    to float32 at use): the in-block impulse response ``L`` (block, block),
    the block-start pickup ``Zmat`` (block, 2S), the block drift weights
    ``Kblk`` (block, 2S), the block matrix ``A^block`` and ``A^P`` for a
    last block of ``P`` real samples (2S, 2S)."""
    L, Zmat, Kblk, Ablk = _cascade_matmul_constants(sos, block)
    A = _cascade_state_space(sos)[0]
    return L, Zmat, Kblk, Ablk, np.linalg.matrix_power(A, P)


def _rowdot(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``M @ v`` over the last axis of ``v`` with each row's terms summed left
    to right, every product and sum rounded on its own."""
    acc = v[..., 0:1] * M[:, 0]
    for s in range(1, M.shape[1]):
        acc = acc + v[..., s:s + 1] * M[:, s]
    return acc


def _cascade_sosfilt_plain(tables, x: torch.Tensor, zi: torch.Tensor):
    """K4's plain version: ``x`` (R, T), ``zi`` (R, 2S), ``tables`` from
    :func:`cascade_scan_tables` as float32 tensors.  Every dot product is a
    left-to-right sum of separately rounded products, in K4's order:

        c_j     = sum_u Kblk[u] x_j[u]                 (u = 0 .. block-1)
        z_{j+1} = (sum_s A^block[:, s] z_j[s]) + c_j   (s = 0 .. 2S-1)
        y_j[i]  = (sum_{u <= i} L[i, u] x_j[u]) + (sum_s Zmat[i, s] z_j[s])

    and, after a last block of P < block real samples, the final state
    ``(sum_s A^P[:, s] z_last[s]) + sum_{u < P} Kblk[block - P + u] x[u]``.
    Returns ``(y, zf)``."""
    L, Zmat, Kblk, Ablk, Ap = tables
    block = L.shape[0]
    R, T = x.shape
    nb = -(-T // block)
    pad = nb * block - T
    xb = tnf.pad(x, (0, pad)).reshape(R, nb, block)
    c = xb[..., 0:1] * Kblk[0]
    for u in range(1, block):
        c = c + xb[..., u:u + 1] * Kblk[u]
    zs = x.new_empty((R, nb, Ablk.shape[0]))
    z = zi
    steps = nb if pad == 0 else nb - 1  # the last partial block's state: A^P below
    for j in range(nb):
        zs[:, j] = z
        if j < steps:
            z = _rowdot(Ablk, z) + c[:, j]
    acc = xb[..., 0:1] * L[:, 0]
    for u in range(1, block):
        acc[..., u:] = acc[..., u:] + xb[..., u:u + 1] * L[u:, u]
    y = (acc + _rowdot(Zmat, zs)).reshape(R, nb * block)[:, :T]
    if pad:
        P = block - pad
        d = xb[:, -1, 0:1] * Kblk[block - P]
        for u in range(1, P):
            d = d + xb[:, -1, u:u + 1] * Kblk[block - P + u]
        z = _rowdot(Ap, zs[:, -1]) + d
    return y, z


def cascade_sosfilt(sos: np.ndarray, x: torch.Tensor, zi: torch.Tensor):
    """``_sosfilt_cascade_matmul(boundary="scan")`` of the JAX package
    (``filters.py:518-650``): the cascade over the last axis of ``x`` from
    ``zi`` ((S, 2) or (..., S, 2)), as block drifts, the sequential walk over
    block-start states and the in-block outputs, by
    :func:`_cascade_sosfilt_plain` (the port's kernel K4 gives its bits).  Returns ``(y, zf)``, ``zf`` (..., S, 2).
    """
    sos = np.asarray(sos, dtype=np.float64)
    S = sos.shape[0]
    x = x.to(torch.float32)
    lead, T = x.shape[:-1], x.shape[-1]
    xr = x.reshape(-1, T).contiguous()
    R = xr.shape[0]
    zir = zi.to(device=x.device, dtype=torch.float32)
    zir = zir.reshape(zir.shape[:-2] + (2 * S,)).expand(lead + (2 * S,)).reshape(R, 2 * S)
    zir = zir.contiguous()
    P = T - (-(-T // K4_BLOCK) - 1) * K4_BLOCK  # real samples in the last block
    y, zf = _cascade_sosfilt_plain(host(lambda: cascade_scan_tables(sos, K4_BLOCK, P)), xr, zir)
    y = y.reshape(lead + (T,))
    return y, zf.reshape(lead + (S, 2))


def sosfilt(sos: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """Causal cascade filter over the last axis from zero state, scipy
    ``sosfilt`` semantics: :func:`cascade_sosfilt`."""
    sos = np.asarray(sos, dtype=np.float64)
    x = x.to(torch.float32)
    return cascade_sosfilt(sos, x, x.new_zeros((sos.shape[0], 2)))[0]


def sosfiltfilt(sos: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """Zero-phase forward-backward filter over the last axis; scipy
    ``sosfiltfilt`` parity (``filters.py:715-762``).

    Odd extension with ``padlen = 3 * (2*n_sections + 1 - min(#(b2==0),
    #(a2==0)))`` and ``sosfilt_zi``-scaled initial conditions (scaled by the
    first / last extended sample on the forward / backward pass).  Both
    passes use the log-depth block-boundary prefix.
    """
    sos = np.asarray(sos, dtype=np.float64)
    n_sections = sos.shape[0]
    ntaps = 2 * n_sections + 1
    ntaps -= min((sos[:, 2] == 0).sum(), (sos[:, 5] == 0).sum())
    padlen = 3 * ntaps

    n = x.shape[-1]
    # odd extension: 2*x[0] - x[padlen:0:-1]  |  x  |  2*x[-1] - x[-2:-padlen-2:-1]
    left = 2.0 * x[..., :1] - x[..., 1 : padlen + 1].flip(-1)
    right = 2.0 * x[..., -1:] - x[..., -padlen - 1 : -1].flip(-1)
    ext = torch.cat([left, x, right], dim=-1)

    zi0 = host(lambda: sosfilt_zi(sos))
    y = _sosfilt_cascade_matmul(sos, ext, zi0 * ext[..., :1, None])
    y = _sosfilt_cascade_matmul(sos, y, zi0 * y[..., -1:, None], reverse=True)
    return y[..., padlen : padlen + n]


# ---------------------------------------------------------------------------
# The engine's prefilter design (band edges clipped exactly like the engine)
# ---------------------------------------------------------------------------


def design_highpass(sr: float, cutoff_hz: float, order: int = 4) -> np.ndarray:
    """HP design clipped like ``edge/rain_signal_processor.py:360-362``."""
    nyq = 0.5 * sr
    wn = float(np.clip(cutoff_hz / nyq, 1e-4, 0.9999))
    return butter_sos(order, wn, "highpass")


