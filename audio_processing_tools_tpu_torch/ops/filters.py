"""IIR (biquad cascade) filtering: host design, device run.

Counterpart of ``audio_processing_tools_tpu/ops/filters.py``.

* **Design** is NumPy on the host, copied as it is from the JAX package:
  ``butter_sos`` and its helpers (``:45-262``), ``sosfilt_zi`` (``:264``),
  ``_cascade_state_space``, ``_cascade_matmul_constants`` and
  ``_boundary_logdepth_powers`` (``:421-515``), ``design_highpass`` /
  ``design_bandpass`` (``:770-792``).
* **Run**: :func:`_sosfilt_cascade_matmul` (``:518-635``) in its
  ``boundary="logdepth"`` form, forward and ``reverse=True``, and
  :func:`sosfiltfilt` (``:715-762``) with scipy's odd extension and padlen
  rule.  The whole cascade is two constant matrix products per 128-sample
  block plus a log-depth prefix over block-boundary states; the products are
  plain float32 ``torch.matmul`` (the JAX package ran them outside any
  Pallas kernel), with TF32 disabled at package import.

The sequential ``scan`` boundary form, ``zi``/``zf`` streaming and
``_sosfilt_section_pscan`` belong to the streaming path (ROADMAP P13).
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch
import torch.nn.functional as tnf

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
                            reverse: bool = False,
                            boundary: str = "logdepth") -> torch.Tensor:
    """Whole-cascade ``sosfilt`` over the last axis (y only).

    With block-start state ``z`` and in-block index ``i`` the output is
    ``y[i] = Zmat[i] . z + sum_u L[i, u] x[u]``: two constant products.  The
    block-start states come from a Hillis-Steele doubling prefix over the
    block composite drifts, weighted by ``(A^block)^(2^k)``.

    ``zi``: (..., n_sections, 2) initial conditions (scipy layout).
    ``reverse=True`` computes ``flip(filter(flip(x)))`` without
    materializing a flip: the in-block constants are rotated by 180 degrees
    and the prefix runs right to left.
    """
    if boundary != "logdepth":
        raise NotImplementedError(
            f"boundary={boundary!r}: the sequential block-boundary scan belongs "
            "to the streaming path (ROADMAP P13)"
        )
    sos = np.asarray(sos, dtype=np.float64)
    S = sos.shape[0]
    dev = x.device
    T = x.shape[-1]
    lead = x.shape[:-1]
    nb = -(-T // block)
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
