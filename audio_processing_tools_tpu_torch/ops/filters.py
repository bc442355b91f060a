"""IIR (biquad cascade) filtering: host design, device run.

Counterpart of ``audio_processing_tools_tpu/ops/filters.py``.

* **Design** is NumPy on the host, copied as it is from the JAX package:
  ``butter_sos`` and its helpers (``:45-262``), ``sosfilt_zi`` (``:264``),
  ``_cascade_state_space``, ``_cascade_matmul_constants`` and
  ``_boundary_logdepth_powers`` (``:421-515``), ``design_highpass`` /
  ``design_bandpass`` (``:770-792``).
* **Run, offline**: :func:`_sosfilt_cascade_matmul` (``:518-650``) in its
  ``boundary="logdepth"`` form, forward and ``reverse=True``, and
  :func:`sosfiltfilt` (``:715-762``) with scipy's odd extension and padlen
  rule.  The whole cascade is two constant matrix products per 128-sample
  block plus a log-depth prefix over block-boundary states; the products
  are plain float32 ``torch.matmul`` (the JAX package ran them outside any
  Pallas kernel), with TF32 disabled at package import.
* **Run, sequential boundary**: :func:`cascade_sosfilt`, the
  ``boundary="scan"`` form of ``_sosfilt_cascade_matmul`` with its exact
  final state (``sosfilt_matmul_zf``, ``:652-666``), which band noise runs
  and :func:`sosfilt` without ``zi`` runs from zero state: on a CUDA tensor
  the hand-written kernel K4 (``csrc/cascade.cu``), on a CPU tensor its
  plain version :func:`_cascade_sosfilt_plain`.  No library product: every
  dot product is a left-to-right sum in one fixed order, so both give the
  same bits, and a stream cut into multiples of 128 samples gives the bits
  of one call.
* :func:`sosfilt` with ``zi`` returns ``(y, zf)``, the streaming detector's
  causal prefilter (``:669-712``, whose per-section blocked scan is
  ``_sosfilt_section_pscan``, ``:290-411``): on a CUDA tensor the
  hand-written kernel K7 (``csrc/filters.cu``), one thread per stream
  walking the samples in order; its plain version :func:`_sosfilt_zi_plain`
  walks them the same way.  Both give the same bits for any cut of a stream
  into chunks.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch
import torch.nn.functional as tnf

from audio_processing_tools_tpu_torch import _kernels
from audio_processing_tools_tpu_torch.ops._device import device_constant


# ---------------------------------------------------------------------------
# Host-side Butterworth design (NumPy), copied from the JAX package
# ---------------------------------------------------------------------------


def _butter_analog_poles(order: int) -> np.ndarray:
    k = np.arange(1, order + 1)
    theta = np.pi * (2 * k - 1) / (2 * order) + np.pi / 2
    return np.exp(1j * theta)  # unit-circle poles, left half plane


def butter_sos(order: int, wn, btype: str = "lowpass") -> np.ndarray:
    """Butterworth digital filter in second-order sections.

    Equivalent to ``scipy.signal.butter(order, wn, btype, output="sos")``
    for lowpass/highpass/bandpass/bandstop.  ``wn`` is normalized to Nyquist
    (scipy convention).  Pure NumPy float64; returns ``(n_sections, 6)``.

    When scipy is importable (it is in the supported environment) the design
    is delegated to ``scipy.signal.butter`` so the SOS *section ordering and
    zero pairing* match scipy exactly: the hand-rolled ``_zpk_to_sos`` below
    produces the same transfer function but orders the highest-Q section
    first, which measurably degrades float32 cascade numerics (a ~7% local
    deviation vs float64 sosfiltfilt on 2-s clips, found by the differential
    harness in ``tests/test_reference_differential.py``) and breaks
    decision-level parity with the reference's scipy filters.  Design runs at
    trace time on the host, so this costs nothing on device.
    """
    try:
        import scipy.signal as _spsig
    except ImportError:
        _spsig = None
    if _spsig is not None:
        return np.asarray(
            _spsig.butter(order, wn, btype=btype, output="sos"), np.float64
        )
    btype = btype.lower()
    if btype in ("band", "bandpass"):
        btype = "bandpass"
    if btype in ("bs", "bandstop"):
        btype = "bandstop"
    if btype in ("low", "lowpass"):
        btype = "lowpass"
    if btype in ("high", "highpass"):
        btype = "highpass"

    poles = _butter_analog_poles(order)
    zeros = np.array([], dtype=complex)
    gain = 1.0

    # Pre-warp
    if btype in ("lowpass", "highpass"):
        warped = 2.0 * 2.0 * np.tan(np.pi * float(np.atleast_1d(wn)[0]) / 2.0) / 2.0
        # fs=2 convention: warped = 2*fs*tan(pi*wn/(2)) / ... simplify below
        fs = 2.0
        warped = 2.0 * fs * np.tan(np.pi * float(np.atleast_1d(wn)[0]) / fs)
    else:
        wn = np.atleast_1d(np.asarray(wn, dtype=np.float64))
        fs = 2.0
        warped = 2.0 * fs * np.tan(np.pi * wn / fs)

    if btype == "lowpass":
        z, p, k = _lp2lp(zeros, poles, gain, warped)
    elif btype == "highpass":
        z, p, k = _lp2hp(zeros, poles, gain, warped)
    elif btype == "bandpass":
        bw = warped[1] - warped[0]
        wo = np.sqrt(warped[0] * warped[1])
        z, p, k = _lp2bp(zeros, poles, gain, wo, bw)
    elif btype == "bandstop":
        bw = warped[1] - warped[0]
        wo = np.sqrt(warped[0] * warped[1])
        z, p, k = _lp2bs(zeros, poles, gain, wo, bw)
    else:
        raise ValueError(f"unsupported btype {btype!r}")

    z, p, k = _bilinear_zpk(z, p, k, fs=2.0)
    return _zpk_to_sos(z, p, k)


def _lp2lp(z, p, k, wo):
    degree = len(p) - len(z)
    return z * wo, p * wo, k * wo**degree


def _lp2hp(z, p, k, wo):
    degree = len(p) - len(z)
    zh = wo / z if len(z) else np.array([], dtype=complex)
    ph = wo / p
    zh = np.append(zh, np.zeros(degree))
    kh = k * np.real(np.prod(-z) / np.prod(-p)) if len(z) else k * np.real(1.0 / np.prod(-p))
    return zh, ph, kh


def _lp2bp(z, p, k, wo, bw):
    degree = len(p) - len(z)
    z_lp = z * bw / 2
    p_lp = p * bw / 2
    z_bp = np.concatenate(
        [z_lp + np.sqrt(z_lp**2 - wo**2), z_lp - np.sqrt(z_lp**2 - wo**2)]
    ) if len(z_lp) else np.array([], dtype=complex)
    p_bp = np.concatenate(
        [p_lp + np.sqrt(p_lp**2 - wo**2), p_lp - np.sqrt(p_lp**2 - wo**2)]
    )
    z_bp = np.append(z_bp, np.zeros(degree))
    k_bp = k * bw**degree
    return z_bp, p_bp, k_bp


def _lp2bs(z, p, k, wo, bw):
    degree = len(p) - len(z)
    z_hp = (bw / 2) / z if len(z) else np.array([], dtype=complex)
    p_hp = (bw / 2) / p
    z_bs = np.concatenate(
        [z_hp + np.sqrt(z_hp**2 - wo**2), z_hp - np.sqrt(z_hp**2 - wo**2)]
    ) if len(z_hp) else np.array([], dtype=complex)
    p_bs = np.concatenate(
        [p_hp + np.sqrt(p_hp**2 - wo**2), p_hp - np.sqrt(p_hp**2 - wo**2)]
    )
    z_bs = np.append(z_bs, np.full(degree, 1j * wo))
    z_bs = np.append(z_bs, np.full(degree, -1j * wo))
    k_bs = k * np.real(np.prod(-z) / np.prod(-p)) if len(z) else k * np.real(1.0 / np.prod(-p))
    return z_bs, p_bs, k_bs


def _bilinear_zpk(z, p, k, fs):
    degree = len(p) - len(z)
    fs2 = 2.0 * fs
    z_d = (fs2 + z) / (fs2 - z)
    p_d = (fs2 + p) / (fs2 - p)
    z_d = np.append(z_d, -np.ones(degree))
    k_d = k * np.real(np.prod(fs2 - z) / np.prod(fs2 - p))
    return z_d, p_d, k_d


def _pair_conjugates(vals: np.ndarray):
    """Split roots into conjugate pairs + reals (sorted for determinism)."""
    vals = np.asarray(vals)
    complex_vals = vals[np.abs(vals.imag) > 1e-12]
    real_vals = np.real(vals[np.abs(vals.imag) <= 1e-12])
    # keep one of each conjugate pair
    upper = complex_vals[complex_vals.imag > 0]
    upper = upper[np.argsort(-np.abs(upper))]
    real_vals = real_vals[np.argsort(-np.abs(real_vals))]
    return upper, real_vals


def _zpk_to_sos(z, p, k) -> np.ndarray:
    """Convert zpk to SOS (simplified pairing valid for Butterworth designs).

    Butterworth digital designs have zeros only at z=+1/-1 (possibly +-j*w0
    for bandstop) and complex-conjugate pole pairs, so a greedy
    nearest-zero-to-pole pairing suffices and matches scipy's output up to
    section ordering/rounding.
    """
    z = np.asarray(z, dtype=complex).copy()
    p = np.asarray(p, dtype=complex).copy()
    n = max(len(z), len(p))
    if n % 2 == 1:
        z = np.append(z, 0.0) if len(z) < n else z
        p = np.append(p, 0.0) if len(p) < n else p
    # pad to equal length
    while len(z) < len(p):
        z = np.append(z, 0.0)
    while len(p) < len(z):
        p = np.append(p, 0.0)

    p_upper, p_real = _pair_conjugates(p)
    z_upper, z_real = _pair_conjugates(z)

    sections = []
    z_pool = list(z_upper) + list(z_real)

    def take_nearest(pool, target, count):
        got = []
        for _ in range(count):
            if not pool:
                break
            i = int(np.argmin([abs(c - target) for c in pool]))
            got.append(pool.pop(i))
        return got

    # complex pole pairs
    for pp in p_upper:
        zz = take_nearest(z_pool, pp, 1)
        num_roots = []
        for c in zz:
            if abs(np.imag(c)) > 1e-12:
                num_roots += [c, np.conj(c)]
            else:
                # try to grab a second real zero for a full biquad numerator
                extra = take_nearest([c2 for c2 in z_pool if abs(np.imag(c2)) <= 1e-12], c, 1)
                if extra:
                    z_pool.remove(extra[0])
                    num_roots += [c, extra[0]]
                else:
                    num_roots += [c]
        b = np.real(np.poly(num_roots)) if num_roots else np.array([1.0])
        a = np.real(np.poly([pp, np.conj(pp)]))
        b = np.concatenate([b, np.zeros(3 - len(b))])
        sections.append(np.concatenate([b, a]))
    # leftover real poles in pairs
    p_real = list(p_real)
    while p_real:
        pr = [p_real.pop(0)]
        if p_real:
            pr.append(p_real.pop(0))
        zz = take_nearest(z_pool, pr[0], len(pr))
        b = np.real(np.poly(zz)) if zz else np.array([1.0])
        a = np.real(np.poly(pr))
        b = np.concatenate([b, np.zeros(3 - len(b))])
        a = np.concatenate([a, np.zeros(3 - len(a))])
        sections.append(np.concatenate([b, a]))

    sos = np.asarray(sections, dtype=np.float64)
    sos[0, :3] *= np.real(k)
    return sos


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


# LRU-bounded: grid searches over band edges/orders design many distinct
# filters, and each entry holds O(block^2 + block*4S^2) float64 constants.
# Recomputing on a miss is cheap host-side NumPy, so a small bound suffices.
_CASCADE_CONST_CACHE: OrderedDict = OrderedDict()
_CASCADE_CONST_CACHE_MAX = 32


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
    key = (sos.tobytes(), int(block))
    hit = _CASCADE_CONST_CACHE.get(key)
    if hit is not None:
        _CASCADE_CONST_CACHE.move_to_end(key)
        return hit
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
    out = (L, Zmat, Kblk, powers[block])
    _CASCADE_CONST_CACHE[key] = out
    while len(_CASCADE_CONST_CACHE) > _CASCADE_CONST_CACHE_MAX:
        _CASCADE_CONST_CACHE.popitem(last=False)
    return out


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
    dev = x.device
    lead = x.shape[:-1]
    pad = nb * block - T

    def make():
        L, Zmat, Kblk, _ = _cascade_matmul_constants(sos, block)
        if reverse:
            L, Zmat, Kblk = L[::-1, ::-1], Zmat[::-1], Kblk[::-1]
        return tuple(np.ascontiguousarray(a) for a in (L.T, Zmat.T, Kblk))

    Lt, Zt, Kc = device_constant(("cascade", sos.tobytes(), block, reverse), dev, make)

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
    ladder = device_constant(
        ("ladder", sos.tobytes(), block, nb), dev,
        lambda: tuple(np.ascontiguousarray(Ak.T)
                      for Ak in _boundary_logdepth_powers(sos, block, nb)),
    )
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
#: second-order sections K4 takes (a state of 2 S <= 16 values)
K4_MAX_SECTIONS = 8


def cascade_scan_tables(sos: np.ndarray, block: int, P: int):
    """Host constants of the sequential-boundary cascade, float64 (rounded
    to float32 at use): the in-block impulse response ``L`` (block, block),
    the block-start pickup ``Zmat`` (block, 2S), the block drift weights
    ``Kblk`` (block, 2S), the block matrix ``A^block`` and ``A^P`` for a
    last block of ``P`` real samples (2S, 2S)."""
    L, Zmat, Kblk, Ablk = _cascade_matmul_constants(sos, block)
    A = _cascade_state_space(sos)[0]
    return L, Zmat, Kblk, Ablk, np.linalg.matrix_power(A, P)


def _k4_flat_tables(sos: np.ndarray, P: int) -> np.ndarray:
    """K4's one table: ``L[:, 0]`` (``L`` is Toeplitz, ``L[i, u] = L[i - u,
    0]``) | Kblk | Zmat | A^128 | A^P, row-major."""
    L, Zmat, Kblk, Ablk, Ap = cascade_scan_tables(sos, K4_BLOCK, P)
    return np.concatenate([L[:, 0], Kblk.ravel(), Zmat.ravel(), Ablk.ravel(), Ap.ravel()])


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


def _cascade_sosfilt_cuda(tables: torch.Tensor, x: torch.Tensor, zi: torch.Tensor,
                          n_sections: int):
    """K4 on the card: ``(y, zf)`` from the flat table of
    :func:`_k4_flat_tables`."""
    R, T = x.shape
    n = 2 * n_sections
    _kernels.require_cuda("cascade_sosfilt", x, torch.float32, 2)
    _kernels.require_cuda("cascade_sosfilt(zi)", zi, torch.float32, 2)
    if zi.shape != (R, n) or zi.device != x.device or tables.device != x.device:
        raise ValueError(f"cascade_sosfilt: zi must be ({R}, {n}) on {x.device}; "
                         f"got {tuple(zi.shape)} on {zi.device}")
    if not 1 <= n_sections <= K4_MAX_SECTIONS:
        raise ValueError(f"cascade_sosfilt: the CUDA kernel takes 1 to {K4_MAX_SECTIONS} "
                         f"sections; got {n_sections}")
    nb = -(-T // K4_BLOCK)
    y = torch.empty_like(x)
    zf = torch.empty_like(zi)
    drifts = torch.empty((R, nb, n), dtype=torch.float32, device=x.device)
    starts = torch.empty_like(drifts)
    lib = _kernels.build()
    with torch.cuda.device(x.device):
        err = lib.lib.apt_cascade_sosfilt(x.data_ptr(), tables.data_ptr(), zi.data_ptr(),
                                          y.data_ptr(), zf.data_ptr(), drifts.data_ptr(),
                                          starts.data_ptr(), R, T, n_sections,
                                          _kernels.stream_of(x))
    lib.check(err, "cascade_sosfilt")
    _kernels.count("cascade_sosfilt")
    return y, zf


def cascade_sosfilt(sos: np.ndarray, x: torch.Tensor, zi: torch.Tensor):
    """``_sosfilt_cascade_matmul(boundary="scan")`` of the JAX package
    (``filters.py:518-650``): the cascade over the last axis of ``x`` from
    ``zi`` ((S, 2) or (..., S, 2)), as block drifts, the sequential walk over
    block-start states and the in-block outputs.  Kernel K4 on a CUDA
    tensor, :func:`_cascade_sosfilt_plain` on a CPU tensor; both give the
    same bits, and so does any cut of a stream into multiples of 128 samples
    with the final state carried.  Returns ``(y, zf)``, ``zf`` (..., S, 2).
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
    if T == 0:
        y, zf = xr, zir
    else:
        P = T - (-(-T // K4_BLOCK) - 1) * K4_BLOCK  # real samples in the last block
        if x.device.type == "cpu":
            tables = device_constant(("k4_plain", sos.tobytes(), P), x.device,
                                     lambda: cascade_scan_tables(sos, K4_BLOCK, P))
            y, zf = _cascade_sosfilt_plain(tables, xr, zir)
        else:
            tables = device_constant(("k4", sos.tobytes(), P), x.device,
                                     lambda: _k4_flat_tables(sos, P))
            y, zf = _cascade_sosfilt_cuda(tables, xr, zir, S)
    y = y.reshape(lead + (T,))
    return y, zf.reshape(lead + (S, 2))


def _sos_coefficients(sos: np.ndarray) -> np.ndarray:
    """``(S, 5)`` b0, b1, b2, a1, a2 per section, rounded to float32 as the
    JAX package's scan rounds its Python-float constants."""
    return np.ascontiguousarray(np.asarray(sos, np.float64)[:, [0, 1, 2, 4, 5]], np.float32)


def _sosfilt_zi_plain(coef: torch.Tensor, x: torch.Tensor, zi: torch.Tensor):
    """Direct Form II transposed over ``x`` (R, n) from ``zi`` (R, S, 2),
    sample by sample, every product and sum rounded on its own:

        y = b0 x + z0;  z0 = (b1 x - a1 y) + z1;  z1 = b2 x - a2 y

    The sections run as a wavefront (section s filters sample t - s at step
    t), which is the same arithmetic in fewer steps.  Returns ``(y, zf)``."""
    R, n = x.shape
    S = coef.shape[0]
    z0 = zi[..., 0].clone()
    z1 = zi[..., 1].clone()
    u = x.new_zeros(R, S)   # each section's input at this step
    yy = x.new_zeros(R, S)  # each section's output at this step
    t1 = x.new_empty(R, S)
    t2 = x.new_empty(R, S)
    y = x.new_empty(R, n)
    xT = x.t()
    # views made once: the loop's own indexing would cost more than its work
    u_in, u_first, y_prev, y_last = u[:, 1:], u[:, 0], yy[:, :-1], yy[:, S - 1]
    full = (*coef.unbind(1), u, yy, z0, z1, t1, t2)

    def step(b0, b1, b2, a1, a2, u, yy, z0, z1, t1, t2):
        torch.mul(b0, u, out=yy)
        yy += z0
        torch.mul(b1, u, out=t1)
        torch.mul(a1, yy, out=t2)
        t1 -= t2
        torch.add(t1, z1, out=z0)
        torch.mul(b2, u, out=t1)
        torch.mul(a2, yy, out=t2)
        torch.sub(t1, t2, out=z1)

    for t in range(n + S - 1):
        u_in.copy_(y_prev)
        if t < n:
            u_first.copy_(xT[t])
        lo, hi = max(0, t - n + 1), min(S, t + 1)  # sections at work
        if hi - lo == S:
            step(*full)
        else:
            step(*(a[..., lo:hi] for a in full))
        if t >= S - 1:
            y[:, t - S + 1] = y_last
    return y, torch.stack([z0, z1], dim=-1)


def _sosfilt_zi_cuda(coef: torch.Tensor, x: torch.Tensor, zi: torch.Tensor):
    """K7: ``(y, zf)`` on the card."""
    R, n = x.shape
    S = coef.shape[0]
    _kernels.require_cuda("sosfilt", x, torch.float32, 2)
    _kernels.require_cuda("sosfilt(zi)", zi, torch.float32, 3)
    if zi.shape != (R, S, 2) or zi.device != x.device or coef.device != x.device:
        raise ValueError(f"sosfilt: zi must be ({R}, {S}, 2) on {x.device}; got {tuple(zi.shape)}")
    if not 1 <= S <= 8:
        raise ValueError(f"sosfilt: the CUDA kernel takes 1 to 8 sections; got {S}")
    y = torch.empty_like(x)
    zf = torch.empty_like(zi)
    lib = _kernels.build()
    with torch.cuda.device(x.device):
        err = lib.lib.apt_sosfilt_zi(x.data_ptr(), coef.data_ptr(), zi.data_ptr(), y.data_ptr(),
                                     zf.data_ptr(), R, n, S, _kernels.stream_of(x))
    lib.check(err, "sosfilt_zi")
    _kernels.count("sosfilt_zi")
    return y, zf


def sosfilt(sos: np.ndarray, x: torch.Tensor, zi: torch.Tensor | None = None):
    """Causal cascade filter over the last axis, scipy ``sosfilt``
    semantics (``filters.py:669-712``).

    Without ``zi``: from zero state, the JAX package's cascade with the
    sequential boundary, :func:`cascade_sosfilt` (kernel K4 on a CUDA
    tensor); returns ``y``.  With ``zi`` ((S, 2) or (..., S, 2)): returns
    ``(y, zf)``, kernel K7 on a CUDA tensor and its plain loop on a CPU
    tensor, the streaming detector's prefilter; carrying ``zf`` into the
    next call as ``zi`` gives the bits of one call over the whole stream."""
    sos = np.asarray(sos, dtype=np.float64)
    x = x.to(torch.float32)
    if zi is None:
        return cascade_sosfilt(sos, x, x.new_zeros((sos.shape[0], 2)))[0]
    S = sos.shape[0]
    lead, n = x.shape[:-1], x.shape[-1]
    xr = x.reshape(-1, n).contiguous()
    zir = zi.to(torch.float32).expand(lead + (S, 2)).reshape(-1, S, 2).contiguous()
    coef = device_constant(("sos_coefficients", sos.tobytes()), x.device,
                           lambda: _sos_coefficients(sos))
    if x.device.type == "cpu":
        y, zf = _sosfilt_zi_plain(coef, xr, zir)
    else:
        y, zf = _sosfilt_zi_cuda(coef, xr, zir)
    return y.reshape(x.shape), zf.reshape(lead + (S, 2))


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
    if n <= padlen:
        raise ValueError(
            f"The length of the input vector x must be greater than padlen={padlen}"
        )

    # odd extension: 2*x[0] - x[padlen:0:-1]  |  x  |  2*x[-1] - x[-2:-padlen-2:-1]
    left = 2.0 * x[..., :1] - x[..., 1 : padlen + 1].flip(-1)
    right = 2.0 * x[..., -1:] - x[..., -padlen - 1 : -1].flip(-1)
    ext = torch.cat([left, x, right], dim=-1)

    zi0 = device_constant(("sosfilt_zi", sos.tobytes()), x.device,
                          lambda: sosfilt_zi(sos))
    y = _sosfilt_cascade_matmul(sos, ext, zi0 * ext[..., :1, None])
    y = _sosfilt_cascade_matmul(sos, y, zi0 * y[..., -1:, None], reverse=True)
    return y[..., padlen : padlen + n]


# ---------------------------------------------------------------------------
# Reference prefilter designs (band edges clipped exactly like the engine)
# ---------------------------------------------------------------------------


def design_highpass(sr: float, cutoff_hz: float, order: int = 4) -> np.ndarray:
    """HP design clipped like ``edge/rain_signal_processor.py:360-362``."""
    nyq = 0.5 * sr
    wn = float(np.clip(cutoff_hz / nyq, 1e-4, 0.9999))
    return butter_sos(order, wn, "highpass")


def design_bandpass(sr: float, lo_hz: float, hi_hz: float, order: int = 4,
                    clip_mode: str = "engine") -> np.ndarray:
    """BP design with the engine's edge clipping.

    ``clip_mode="engine"`` matches ``edge/rain_signal_processor.py:352-358``
    (also used by TD features, ``edge/feature_extraction.py:199-209``):
    lo clipped to [1e-3, 0.999*nyq], hi to [lo+1e-3, 0.999*nyq].
    """
    nyq = 0.5 * sr
    if clip_mode == "engine":
        lo = float(np.clip(lo_hz, 1e-3, nyq * 0.999))
        hi = float(np.clip(hi_hz, lo + 1e-3, nyq * 0.999))
        wn = [lo / nyq, hi / nyq]
    else:
        wn = [lo_hz / nyq, hi_hz / nyq]
    return butter_sos(order, wn, "bandpass")
