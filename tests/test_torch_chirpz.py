"""K1's odd mixed, Rader, global Rader, chirp-z, split, cluster and global
routes and K8's chirp-z and global frame passes, which run only on the
card: NumPy float32 models of their plans, run as the kernels run them (the
odd-length mixed-radix transform, Rader's and the chirp-z transform with
the host's float32 tables, the four-step split with its twiddle, the real
split of a half-length first transform, the cluster route's slices of
columns and rows and its two exchanges), held against
``numpy.fft.rfft`` in float64; the plans' Python twins against the
constants of the CUDA sources; the routes' reach (no geometry the JAX
package runs is refused, none takes the direct DFT); and the JAX package's
``spectrogram_power`` against the port's at sizes these routes take on the
card.
"""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_processing_tools_tpu.ops import spectrogram as jspec
from audio_processing_tools_tpu_torch.models import streaming as ts
from audio_processing_tools_tpu_torch.ops import spectrogram as tspec

CSRC = Path(tspec.__file__).resolve().parent.parent / "csrc"


def _pairs(t):
    return (t[:, 0] + 1j * t[:, 1]).astype(np.complex64)


def _table(tn):
    """e^{-2 pi i j / tn} as the host builds it: float64 rounded to float32."""
    ang = -2.0 * np.pi * np.arange(tn, dtype=np.float64) / tn
    return (np.cos(ang) + 1j * np.sin(ang)).astype(np.complex64)


def _butterfly(v, R, table, tn):
    """``butterfly<R>`` on v (rows, R, butterflies): a register DFT for 2, 4
    and 8; for an odd R the symmetric form of ``dft_odd`` with cs[m] =
    table[m tn / R]."""
    if R % 2 == 0:
        return np.fft.fft(v.astype(np.complex128), axis=1).astype(np.complex64)
    H = R // 2
    cs = table[np.arange(H + 1) * (tn // R)]
    s = [None] + [v[:, j] + v[:, R - j] for j in range(1, H + 1)]
    d = [None] + [v[:, j] - v[:, R - j] for j in range(1, H + 1)]
    out = np.empty_like(v)
    x0 = v[:, 0].copy()
    for j in range(1, H + 1):
        x0 = x0 + s[j]
    out[:, 0] = x0
    for k in range(1, H + 1):
        A, B = v[:, 0].copy(), np.zeros_like(v[:, 0])
        for j in range(1, H + 1):
            m = j * k % R
            c = cs[m].real if m <= H else cs[R - m].real
            sn = -cs[m].imag if m <= H else cs[R - m].imag
            A = A + s[j] * np.float32(c)
            B = B + d[j] * np.float32(sn)
        out[:, k] = A - 1j * B
        out[:, R - k] = A + 1j * B
    return out.astype(np.complex64)


def mixed_fft_model(z, M, table, tn):
    """``mixed_fft``: the M-point transform of each row of z (rows, M), pass
    by pass, twiddles table[(tn / (NS R)) k r] of a table of tn entries."""
    NS = 1
    for R in tspec.mixed_radices(M):
        nb = M // R
        b = np.arange(nb)
        q, k = b // NS, b % NS
        r = np.arange(R)[:, None]
        v = z[:, b[None, :] + r * nb]
        tw = table[(tn // (NS * R)) * k[None, :] * r]
        v = np.where(k[None, None, :] > 0, v * tw[None], v).astype(np.complex64)
        v = _butterfly(v, R, table, tn)
        out = np.empty_like(z)
        out[:, (q * NS * R + k)[None, :] + r * NS] = v
        z, NS = out, NS * R
    return z


def four_step_model(x, N, table, tn):
    """``four_step``: the N-point transform of each row of x (frames, N) as
    N2 column transforms of N1 points, the twiddle e^{-2 pi i n2 k1 / N},
    N1 row transforms of N2 points, X in natural order."""
    plan = tspec.four_step_plan(N)
    N1, N2 = plan.N1, plan.N2
    F = x.shape[0]
    cols = x.reshape(F, N1, N2).transpose(0, 2, 1).reshape(F * N2, N1)
    Y = mixed_fft_model(cols, N1, table, tn).reshape(F, N2, N1)  # Y[f, n2, k1]
    n2, k1 = np.arange(N2)[:, None], np.arange(N1)[None, :]
    tw = table[(tn // N) * n2 * k1]
    Y = np.where((n2 * k1 > 0)[None], Y * tw[None], Y).astype(np.complex64)
    rows = Y.transpose(0, 2, 1).reshape(F * N1, N2)
    X = mixed_fft_model(rows, N2, table, tn).reshape(F, N1, N2)  # X[f, k1, k2]
    return X.transpose(0, 2, 1).reshape(F, N)  # natural order k = k1 + N1 k2


def transform_model(z, N, table, tn):
    """One block's transform up to :data:`ONE_BLOCK_POINTS`, else four-step."""
    if N <= tspec.ONE_BLOCK_POINTS:
        return mixed_fft_model(z, N, table, tn)
    return four_step_model(z, N, table, tn)


def chirpz_model(z, n_fft, M=None):
    """The chirp-z transform of each row of z (frames, L) over N points with
    the host's float32 tables: a = z c zero-padded, the transform, conj(. Bt),
    the transform again, conj(.) c; the K bins the tables serve
    (``chirp_bins``)."""
    c, bt, ctab = (_pairs(t) for t in tspec.chirpz_tables(n_fft, M))
    L, N, K = z.shape[1], ctab.shape[0], tspec.chirp_bins(n_fft)
    a = np.zeros((z.shape[0], N), np.complex64)
    a[:, :L] = z * c
    Y = np.conj(transform_model(a, N, ctab, N) * bt).astype(np.complex64)
    W = transform_model(Y, N, ctab, N)
    return (np.conj(W[:, :K]) * c[:K]).astype(np.complex64)


def rader_model(z, n_fft):
    """Rader's transform of each row of z (frames, L), L prime, with the
    host's tables: a_q = z[g^q], its (L - 1)-point transform A, conj(A Bt),
    the transform again W; X_0 = z_0 + A_0, X[g^-q] = z_0 + conj(W_q)."""
    (gin, qout), tabs = tspec.rader_tables(n_fft)
    bt, rtab = (_pairs(t) for t in tabs)
    R = z.shape[1] - 1
    A = mixed_fft_model(z[:, gin].astype(np.complex64), R, rtab, R)
    W = mixed_fft_model(np.conj(A * bt).astype(np.complex64), R, rtab, R)
    X = (z[:, :1] + np.conj(W[:, qout])).astype(np.complex64)
    X[:, 0] = z[:, 0] + A[:, 0]
    return X


def rader_global_model(z, n_fft, half):
    """The global Rader route on each row of z (frames, L), L prime: a_q =
    z[g^q] and both transforms of R = L - 1 points as four-step FFTs; with
    ``half`` (a real z) the first over R / 2 points of the packed pairs
    a_2m + i a_2m+1, then A_k = E + e^{-2 pi i k / R} O from U_k and
    U_{R/2-k} as the second transform's columns read them, A_0 = Re U_0 +
    Im U_0; X_0 = z_0 + A_0, X[g^-q] = z_0 + conj(W_q)."""
    (gin, qout), tabs = tspec.rader_tables(n_fft)
    bt, rtab = (_pairs(t) for t in tabs)
    R = z.shape[1] - 1
    a = z[:, gin].astype(np.complex64)
    if half:
        H = R // 2
        U = four_step_model((a.real[:, 0::2] + 1j * a.real[:, 1::2]).astype(np.complex64), H,
                            rtab, R)
        k = np.arange(R) % H
        zk, zm = U[:, k], U[:, np.where(k == 0, 0, H - k)]
        f = np.float32(0.5)
        ar, ai = f * (zk.real + zm.real), f * (zk.imag - zm.imag)
        dr, di = f * (zk.real - zm.real), f * (zk.imag + zm.imag)
        w = rtab[:R]
        A = (ar + (w.real * di + w.imag * dr)) + 1j * (ai - (w.real * dr - w.imag * di))
        a0 = (U[:, 0].real + U[:, 0].imag).astype(np.complex64)
    else:
        A = four_step_model(a, R, rtab, R)
        a0 = A[:, 0]
    W = four_step_model(np.conj(A.astype(np.complex64) * bt).astype(np.complex64), R, rtab, R)
    X = (z[:, :1] + np.conj(W[:, qout])).astype(np.complex64)
    X[:, 0] = z[:, 0] + a0
    return X


def split_model(z, n_fft):
    """The split route on each row of z (frames, L), L = P Q
    (``split_plan``), with the host's float32 tables: column n2 (n = Q n1 +
    n2), its P-point transform by Rader's convolution over P - 1 points or
    the chirp-z transform over M points (an odd frame's real columns two as
    one complex column, parted after the transform: X_a = (Z[k] + conj(Z[P - k])) / 2,
    X_b = (Z[k] - conj(Z[P - k])) / 2i; only its rows k1 <= (P - 1) / 2
    kept, the rest their mirrors' conjugates), X[k1] times the twiddle
    e^{-2 pi i n2 k1 / L} of the n_fft table, then the rows' Q-point
    transforms: X[k1 + P k2]."""
    F_, L = z.shape
    plan = tspec.split_plan(L)
    P, Q, M = plan.P, plan.Q, plan.M
    pairs = n_fft % 2 == 1
    n1, n2 = np.arange(P)[:, None], np.arange(Q)[None, :]
    cols = z[:, Q * n1 + n2].transpose(0, 2, 1)  # (frames, Q, P)
    if pairs:  # columns 2p + i (2p + 1), the last alone where Q is odd
        cols = np.concatenate([cols, np.zeros_like(cols[:, :1])], axis=1)[:, : Q + Q % 2]
        cols = (cols[:, 0::2].real + 1j * cols[:, 1::2].real).astype(np.complex64)
    cq = cols.shape[1]
    cols = cols.reshape(-1, P)
    tabs = tspec.split_tables(n_fft)
    if plan.kind == "rader":
        gin, bt, ftab = tabs[0].astype(np.int64), _pairs(tabs[1]), _pairs(tabs[2])
        A = mixed_fft_model(cols[:, gin].astype(np.complex64), M, ftab, M)
        W = mixed_fft_model(np.conj(A * bt).astype(np.complex64), M, ftab, M)
        Y = np.empty_like(cols)
        Y[:, gin[(-np.arange(M)) % M]] = cols[:, :1] + np.conj(W)  # X[g^-q]
        Y[:, 0] = cols[:, 0] + A[:, 0]
    else:
        c, bt, ftab = (_pairs(t) for t in tabs)
        a = np.zeros((cols.shape[0], M), np.complex64)
        a[:, :P] = cols * c
        W = chirpz_convolve_model(a, bt, ftab)
        Y = (np.conj(W[:, :P]) * c).astype(np.complex64)
    Y = Y.reshape(F_, cq, P)  # Y[f, column, k1]
    rows = P
    if pairs:
        Ym = np.conj(Y[:, :, (-np.arange(P)) % P])  # conj(Z[P - k1])
        h = np.float32(0.5)
        ya = h * (Y.real + Ym.real) + 1j * (h * (Y.imag + Ym.imag))
        yb = h * (Y.imag - Ym.imag) + 1j * (h * (Ym.real - Y.real))
        Y = np.stack([ya, yb], axis=2).reshape(F_, 2 * cq, P)[:, :Q].astype(np.complex64)
        rows = (P + 1) // 2
        Y = Y[:, :, :rows]
    k1 = np.arange(rows)[None, :]
    tw = _table(n_fft)[(n_fft // L) * n2.T * k1]
    Y = np.where((n2.T * k1 > 0)[None], Y * tw[None], Y).astype(np.complex64)
    R = Y.transpose(0, 2, 1).reshape(-1, Q)
    X = mixed_fft_model(R, Q, _table(n_fft), n_fft).reshape(F_, rows, Q)  # X[f, k1, k2]
    k = np.arange(L)
    kk1, kk2 = k % P, k // P
    mirror = kk1 >= rows  # X[k] = conj(X[L - k]), row P - k1, column Q - 1 - k2
    out = X[:, np.where(mirror, P - kk1, kk1), np.where(mirror, Q - 1 - kk2, kk2)]
    return np.where(mirror[None], np.conj(out), out).astype(np.complex64)


def lines_model(slices, n, table, tn):
    """The n-point transform of every line of each block's slice (lines,
    n), pass by pass as ``lines_fft`` runs it."""
    return [mixed_fft_model(s, n, table, tn) for s in slices]


def cluster_model(z, n_fft, C=None, spectrum=False):
    """K1's cluster route on each row of z (frames, L) as the kernel runs it,
    with the host's float32 tables over :func:`cluster_plan`'s M = N1 N2
    (``C`` forces the cluster size): each of the C blocks takes N2 / C
    columns (n = N2 n1 + n2) of a = z c, their N1-point transforms, the
    twiddle e^{-2 pi i n2 k1 / M}; the exchange, an explicit re-slicing into
    C slices of N1 / C rows; the rows' N2-point transforms, conj(. Bt), the
    rows' transforms again and the twiddle e^{-2 pi i k1 m2 / M}; the
    exchange back into slices of columns; the columns' transforms: W[m2 +
    N2 m1].  Returns the power of the F = n_fft / 2 + 1 bins, |W_k|^2 for an
    odd frame; for an even one the real split of Z_k = conj(W_k) c_k with
    Z_{L-k}, read from the slice that holds it.  ``spectrum``: the complex
    spectrum Z_k of those bins instead (for an even frame the split's X_k)."""
    frames, L = z.shape
    K = tspec.chirp_bins(n_fft)
    plan = tspec.cluster_plan(L, K, C)
    C, M, N1, N2 = plan.C, plan.M, plan.N1, plan.N2
    nc, nr = N2 // C, N1 // C
    c, bt, ctab = (_pairs(t) for t in tspec._chirp_tables_of(L, K, M))
    a = np.zeros((frames, M), np.complex64)
    a[:, :L] = z * c
    n1, j = np.arange(N1)[:, None], np.arange(nc)[None, :]

    sh = next(sh for sh in range(32) if 4 ** sh >= M)

    def twiddle(v, k, g):  # v * e^{-2 pi i k g / M} where k g > 0, as hi[x >> sh] lo[x mod 2^sh]
        x = k * g
        w = (ctab[(x >> sh) << sh] * ctab[x & ((1 << sh) - 1)]).astype(np.complex64)
        return np.where(x > 0, v * w, v).astype(np.complex64)

    # block r: columns n2 = r nc + j, one line a column: (frames * nc, N1)
    cols = [a[:, N2 * n1 + r * nc + j].transpose(0, 2, 1).reshape(-1, N1) for r in range(C)]
    cols = lines_model(cols, N1, ctab, M)
    k1 = np.arange(N1)[None, None, :]
    Y = [twiddle(y.reshape(frames, nc, N1), k1, r * nc + np.arange(nc)[None, :, None])
         for r, y in enumerate(cols)]  # Y[r][f, j, k1]
    # the exchange: block r' takes rows k1 = r' nr + i, point n2 from block n2 // nc
    rows = [np.concatenate([Y[s][:, :, q * nr : (q + 1) * nr] for s in range(C)], axis=1)
            .transpose(0, 2, 1).reshape(-1, N2) for q in range(C)]  # (frames * nr, N2)
    X = [x.reshape(frames, nr, N2) for x in lines_model(rows, N2, ctab, M)]
    k1r = [q * nr + np.arange(nr)[None, :, None] for q in range(C)]
    k2 = np.arange(N2)[None, None, :]
    V = [np.conj(x * bt[k + N1 * k2]).astype(np.complex64).reshape(-1, N2) for x, k in zip(X, k1r)]
    U = [twiddle(u.reshape(frames, nr, N2), k, k2)
         for u, k in zip(lines_model(V, N2, ctab, M), k1r)]  # U[q][f, i, m2]
    # the exchange back: block r takes columns m2 = r nc + j, point k1 from block k1 // nr
    cols = [np.concatenate([U[s][:, :, r * nc : (r + 1) * nc] for s in range(C)], axis=1)
            .transpose(0, 2, 1).reshape(-1, N1) for r in range(C)]
    W = [w.reshape(frames, nc, N1) for w in lines_model(cols, N1, ctab, M)]  # W[r][f, j, m1]

    def w_at(k):  # W_k from the block that holds it: m2 = k mod N2, block m2 // nc
        m2, m1 = k % N2, k // N2
        return np.stack([W[s][:, jj, mm] for s, jj, mm in zip(m2 // nc, m2 % nc, m1)], axis=1)

    F = n_fft // 2 + 1
    if n_fft % 2:
        w = w_at(np.arange(F))
        if spectrum:
            return (np.conj(w) * c[:F]).astype(np.complex64)
        return (w.real * w.real + w.imag * w.imag).astype(np.float32)
    k = np.arange(L)
    zk = np.conj(w_at(k)) * c[k]
    zm = np.conj(w_at(np.where(k == 0, 0, L - k))) * c[np.where(k == 0, 0, L - k)]
    h, tw = np.float32(0.5), _table(n_fft)[k]
    ar, ai = h * (zk.real + zm.real), h * (zk.imag - zm.imag)
    dr, di = h * (zk.real - zm.real), h * (zk.imag + zm.imag)
    xr, xi = ar + (tw.real * di + tw.imag * dr), ai - (tw.real * dr - tw.imag * di)
    nyq = zk[:, :1].real - zk[:, :1].imag
    if spectrum:
        return np.concatenate([xr + 1j * xi, nyq + 0j], axis=1).astype(np.complex64)
    return np.concatenate([xr * xr + xi * xi, nyq * nyq], axis=1).astype(np.float32)


def chirpz_convolve_model(a, bt, ctab):
    """``chirp_convolve``: the M-point transform, conj(. Bt), the transform
    again; conj(W[k]) c_k is X[k]."""
    M = ctab.shape[0]
    Y = np.conj(mixed_fft_model(a, M, ctab, M) * bt).astype(np.complex64)
    return mixed_fft_model(Y, M, ctab, M)


def spectrum_model(frames, n_fft, half=None, route=None):
    """X[k], k <= n_fft / 2, of windowed frames (frames, n_fft) float32 as
    K1's route for n_fft (or ``route``, forced) forms it: the complex input
    (packed pairs for an even n_fft), its transform of N = :func:`fft_shape`
    points (the chirp-z transform where N differs from the complex length
    L), and for an even n_fft the real split."""
    L, N = tspec.fft_shape(n_fft)
    even = n_fft % 2 == 0
    z = (frames[:, 0::2] + 1j * frames[:, 1::2] if even else frames + 0j).astype(np.complex64)
    route = route or tspec.k1_route(n_fft, n_fft // 2)
    if N == L:
        Z = transform_model(z, L, _table(n_fft), n_fft)
    elif route == "rader":
        Z = rader_model(z, n_fft)
    elif route == "rader_global":
        Z = rader_global_model(z, n_fft, not even if half is None else half)
    elif route == "split":
        Z = split_model(z, n_fft)
    elif route == "cluster":
        return cluster_model(z, n_fft, spectrum=True)
    else:
        Z = chirpz_model(z, n_fft)
    if not even:
        return Z[:, : n_fft // 2 + 1]
    k = np.arange(L)
    zk, zm = Z[:, k], Z[:, np.where(k == 0, 0, L - k)]
    w = _table(n_fft)[k]
    X = 0.5 * (zk + np.conj(zm)) - 1j * w * (0.5 * (zk - np.conj(zm)))
    last = (Z[:, 0].real - Z[:, 0].imag)[:, None]
    return np.concatenate([X, last], axis=1)


# the routes' sizes: odd mixed (385 = 5 7 11), Rader odd (1,009 prime, 1,008
# = 2^4 3^2 7) and even (2,018), chirp-z odd (1,031 prime, 1,030 = 2 5 103;
# 1,111 = 11 101; 2,183 = 37 59: pruned to L + F - 1 points) and even (296:
# L = 4 x 37; 2,062: L = 1,031), global even mixed (16,384), global odd
# mixed (9,075 = 3 5^2 11^2), the whole-length chirp-z transform on chip
# (the cluster route) odd (7,013 prime, 7,012 = 2^2 1,753; 7,003 = 47 149:
# two primes above 31; 10,821 = 3 x 3,607, a cluster of two) and even
# (14,026: L = 7,013; 7,396: L = 2 x 43^2), split with P by Rader even
# (14,530: L = 1,453 x 5) and odd (9,999 = 101 x 99) and by a chirp-z
# transform even (14,010: L = 467 x 15) and odd (7,005), global Rader odd
# (7,681: 7,680 = 2^9 3 5; 12,289: 12,288 = 2^12 3; 65,537: 2^16) and even
# (15,362: L = 7,681)
MODEL_SIZES = {385: "mixed_odd", 1009: "rader", 2018: "rader", 1031: "chirpz", 1111: "chirpz",
               2183: "chirpz", 296: "chirpz", 2062: "chirpz", 16384: "global", 9075: "global",
               7013: "cluster", 7003: "cluster", 14026: "cluster", 7396: "cluster",
               10821: "cluster", 14530: "split", 9999: "split", 14010: "split",
               7005: "split", 7681: "rader_global", 12289: "rader_global",
               15362: "rader_global", 65537: "rader_global"}


@pytest.mark.parametrize("n", list(MODEL_SIZES))
def test_route_models_match_numpy_rfft(n):
    """The model of each route's plan gives ``numpy.fft.rfft`` of Hann-
    windowed frames within 1e-6 of the spectrum's maximum, a quiet frame
    beside loud ones included."""
    assert tspec.k1_route(n, n // 2) == MODEL_SIZES[n]
    rng = np.random.default_rng(n)
    frames = rng.standard_normal((3, n)).astype(np.float32)
    frames[1] *= 1e-3
    frames = frames * tspec.kernel_tables(n)[0][None, :]
    got = spectrum_model(frames, n)
    ref = np.fft.rfft(frames.astype(np.float64), axis=-1)
    for f in range(3):
        assert np.abs(got[f] - ref[f]).max() <= 1e-6 * np.abs(ref[f]).max(), f


@pytest.mark.parametrize("n", [7013, 14026])
def test_chirpz_global_model_matches_numpy_rfft(n):
    """The chirp-z global route, forced where the cluster route now takes
    the geometry (odd 7,013 over the pruned K bins, even 14,026: L = 7,013),
    runs the whole-length chirp-z transform through four-step transforms of
    ``chirp_size`` points past one block and gives ``numpy.fft.rfft`` within
    1e-6 of the maximum, a quiet frame beside loud ones included."""
    L, N = tspec.fft_shape(n)
    assert N != L and N > tspec.ONE_BLOCK_POINTS and tspec.four_step_plan(N) is not None
    rng = np.random.default_rng(n + 2)
    frames = rng.standard_normal((3, n)).astype(np.float32)
    frames[1] *= 1e-3
    frames = frames * tspec.kernel_tables(n)[0][None, :]
    got = spectrum_model(frames, n, route="global")
    ref = np.fft.rfft(frames.astype(np.float64), axis=-1)
    for f in range(3):
        assert np.abs(got[f] - ref[f]).max() <= 1e-6 * np.abs(ref[f]).max(), f


@pytest.mark.parametrize("n, half", [(7681, False), (12289, False)])
def test_rader_global_full_first_transform_matches_numpy_rfft(n, half):
    """The global Rader route with its first transform over all R points of
    a real frame (the form an even frame takes) gives ``numpy.fft.rfft``
    within 1e-6 of the maximum, a quiet frame beside loud ones included."""
    rng = np.random.default_rng(n + 1)
    frames = rng.standard_normal((3, n)).astype(np.float32)
    frames[1] *= 1e-3
    frames = frames * tspec.kernel_tables(n)[0][None, :]
    got = spectrum_model(frames, n, half=half)
    ref = np.fft.rfft(frames.astype(np.float64), axis=-1)
    for f in range(3):
        assert np.abs(got[f] - ref[f]).max() <= 1e-6 * np.abs(ref[f]).max(), f


@pytest.mark.parametrize("L, want", [
    (9999, (101, 99, "rader", 100)), (7265, (1453, 5, "rader", 1452)),
    (7005, (467, 15, "chirpz", 960)), (2 * 37 * 37, None), (7003, None), (7013, None),
    (2 * 7013, None), (2 * 7681, None), (3 * 1031, (1031, 3, "chirpz", 2240)),
    (31 * 29, None), (19998, (101, 198, "rader", 100))])
def test_split_plan(L, want):
    """L = P Q with P the one prime above 31, dividing L once, and Q with a
    plan: P by Rader where P - 1 has a plan, else by the one-block chirp-z
    transform over ``chirp_size(P)``; none for P squared (2 x 37^2), two
    primes above 31 (7,003 = 47 x 149), a prime L (7,013), P too large for
    one block (2 x 7,013: no Rader plan, a chirp-z size past 7,264; 2 x
    7,681: 7,680 past 7,264) or no prime above 31 (29 x 31); an even L by
    Rader (19,998 = 101 x 198)."""
    plan = tspec.split_plan(L)
    assert (None if plan is None else plan[:4]) == want
    if plan is None:
        return
    assert plan.P * plan.Q == L and plan.M == (plan.P - 1 if plan.kind == "rader"
                                                else tspec.chirp_size(plan.P))
    extra = 16 * plan.col.frame_tile if plan.kind == "rader" else 0
    assert plan.col.smem_bytes == 16 * tspec.tile_elems(plan.M, plan.col.frame_tile) + extra
    assert plan.row == tspec.split_row_plan(plan.Q)
    tabs = tspec.split_tables(L if L % 2 else 2 * L)
    assert [t.shape[0] for t in tabs] == ([plan.M] * 3 if plan.kind == "rader"
                                          else [plan.P, plan.M, plan.M])


# the cluster route's model at small sizes, every cluster size: L prime
# (1,031 odd; 2,062 even, L = 1,031) and two primes above 31 (1,517 = 37 x
# 41 odd; 3,034 even, L = 1,517); the card runs the full sizes (phase 46)
@pytest.mark.parametrize("n_fft", [1031, 2062, 1517, 3034])
@pytest.mark.parametrize("C", [2, 4, 8])
def test_cluster_model_matches_numpy_rfft_power(n_fft, C):
    """The cluster route's model forced to a cluster of C blocks (slices of
    columns, the exchange to slices of rows and back, an even frame's real
    split across slices) gives ``numpy.fft.rfft``'s power within 1e-5 of
    each frame's maximum, a quiet frame beside loud ones included."""
    L = n_fft // 2 if n_fft % 2 == 0 else n_fft
    plan = tspec.cluster_plan(L, tspec.chirp_bins(n_fft), C)
    assert plan.C == C and plan.M % (C * C) == 0 and plan.M >= L + tspec.chirp_bins(n_fft) - 1
    rng = np.random.default_rng(n_fft + C)
    frames = rng.standard_normal((3, n_fft)).astype(np.float32)
    frames[1] *= 1e-3
    frames = frames * tspec.kernel_tables(n_fft)[0][None, :]
    z = (frames[:, 0::2] + 1j * frames[:, 1::2] if n_fft % 2 == 0 else frames + 0j)
    got = cluster_model(z.astype(np.complex64), n_fft, C)
    ref = np.abs(np.fft.rfft(frames.astype(np.float64), axis=-1)) ** 2
    assert got.shape == ref.shape
    for f in range(3):
        assert np.abs(got[f] - ref[f]).max() <= 1e-5 * ref[f].max(), f


@pytest.mark.parametrize("n_fft, want", [
    (7013, (1, 10752)), (7003, (1, 10752)), (7396, (1, 7680)), (10821, (2, 16384)),
    (30011, (4, 47040)), (40009, (8, 61440)), (79999, None)])
def test_cluster_plan(n_fft, want):
    """The cluster route's plan: the smallest cluster whose blocks hold two
    buffers of M / C points and their tables, M 7-smooth from L + K - 1 with
    C^2 | M (C divides both N1 and N2), the fewest passes, then the
    smallest; none past a cluster of 8 (79,999 prime: 119,998 points and
    more)."""
    L = n_fft // 2 if n_fft % 2 == 0 else n_fft
    K = tspec.chirp_bins(n_fft)
    plan = tspec.cluster_plan(L, K)
    assert (None if plan is None else (plan.C, plan.M)) == want
    if plan is None:
        assert tspec.k1_route(n_fft, n_fft // 2) == "global"
        return
    C, M = plan.C, plan.M
    assert tspec.k1_route(n_fft, n_fft // 2) == "cluster"
    assert M % (C * C) == 0 and plan.N1 % C == 0 and plan.N2 % C == 0
    assert plan.N1 * plan.N2 == M and plan.N1 <= plan.N2 and M >= L + K - 1
    assert set(tspec.mixed_radices(M)) <= {2, 3, 4, 5, 7, 8}
    assert 16 * M // C < plan.smem_bytes <= tspec.SMEM_LIMIT
    assert plan.smem_bytes == tspec.cluster_split(M, C)[2]
    for c in tspec.CLUSTER_SIZES:
        if c < C:
            assert tspec.cluster_plan(L, K, c) is None, c


def test_k1_route_takes_cluster_wherever_it_has_a_plan():
    """Every 97th n_fft over 7,000-70,000 at hop n_fft / 2: no geometry
    whose chirp-z size passes one block takes the chirp-z global route where
    the cluster route has a plan; each such geometry that neither Rader's
    routes nor the split route take takes the cluster route, at every
    cluster size among them."""
    sizes = set()
    for n in range(7000, 70001, 97):
        L, N = tspec.fft_shape(n)
        route = tspec.k1_route(n, n // 2)
        plan = tspec.cluster_plan(L, tspec.chirp_bins(n))
        if N == L or N <= tspec.ONE_BLOCK_POINTS or plan is None:
            continue
        assert route != "global", n
        if route not in ("rader", "rader_global", "split"):
            assert route == "cluster", n
            sizes.add(plan.C)
    assert sizes == set(tspec.CLUSTER_SIZES)


@pytest.mark.parametrize("n_fft, hop, route", [
    (9999, 4999, "split"), (14530, 7265, "split"), (7005, 3502, "split"), (14010, 7005, "split"),
    (7013, 3506, "cluster"), (7003, 3501, "cluster"), (296, 148, "chirpz"), (1111, 555, "chirpz"),
    (6186, 3093, "chirpz")])
def test_k1_route_takes_split(n_fft, hop, route):
    """A complex length whose chirp-z size passes one block and that splits
    takes the split route; one that does not split takes the whole-length
    chirp-z transform on chip (the cluster route, which replaced the chirp-z
    global route there); a chirp-z size within one block keeps the chirp-z route, whether
    or not L splits (296: 4 x 37; 6,186: L = 3 x 1,031); the split route's
    scratch holds two chunk buffers of a frame's kept points (an odd
    frame's (P + 1) / 2 rows)."""
    assert tspec.k1_route(n_fft, hop) == route
    L, N = tspec.fft_shape(n_fft)
    assert N != L
    if route != "split":
        return
    plan = tspec.split_plan(L)
    S = tspec.split_frame_points(n_fft)
    assert S == (L if n_fft % 2 == 0 else (plan.P + 1) // 2 * plan.Q)
    assert tspec.split_scratch_bytes(n_fft, 10 ** 6) == 16 * S * tspec.chunk_frames(S, 10 ** 6)


@pytest.mark.parametrize("n_fft, hop, route", [
    (65537, 32768, "rader_global"), (12289, 6144, "rader_global"), (7681, 3840, "rader_global"),
    (131074, 65537, "rader_global"), (15362, 7681, "rader_global"), (1009, 504, "rader"),
    (7283, 3641, "cluster"), (1031, 515, "chirpz")])
def test_k1_route_takes_rader_global(n_fft, hop, route):
    """A prime complex length whose L - 1 passes one block and has a
    four-step split takes the global Rader route, whatever the parity of
    n_fft; one block's Rader route keeps its primes; a prime whose L - 1
    has no split (7,283: 7,282 = 2 11 331, now on the cluster route) and
    one with no Rader plan (1,031) keep the chirp-z transform."""
    assert tspec.k1_route(n_fft, hop) == route
    L = n_fft // 2 if n_fft % 2 == 0 else n_fft
    assert tspec.rader_global_takes(L) == (route == "rader_global")
    if route == "rader_global":
        R = L - 1
        # an odd n_fft's first transform over packed pairs has its split too
        assert n_fft % 2 == 0 or tspec.four_step_plan(R // 2) is not None
        frames = tspec.chunk_frames(R, 10 ** 6)
        assert tspec.rader_global_scratch_bytes(L, 10 ** 6) == (16 * R + 8) * frames
        assert 16 * R * frames <= tspec.CHUNK_SCRATCH


def test_chirp_size_reaches_the_wanted_bins():
    """The chirp-z size of an odd n_fft starts at L + F - 1, the lags of its
    F = n_fft / 2 + 1 bins; an even n_fft's at 2L - 1 (its split reads every
    bin); each size 7-smooth, and the tables' b zero outside those lags."""
    for n_fft in list(range(1, 3000)) + [9999, 14530, 65537]:
        L, K = (n_fft // 2, n_fft // 2) if n_fft % 2 == 0 else (n_fft, n_fft // 2 + 1)
        assert tspec.chirp_bins(n_fft) == K
        if L < 1:
            continue
        M = tspec.chirp_size(L, K)
        assert M >= max(2, L + K - 1) and set(tspec.mixed_radices(M)) <= {2, 3, 4, 5, 7, 8}
        assert M >= (max(2, 2 * L - 1) if n_fft % 2 == 0 else (3 * n_fft - 1) // 2)
        assert M <= tspec.chirp_size(L)
    _, bt, _ = tspec.chirpz_tables(1031)
    b = np.fft.ifft(_pairs(bt).astype(np.complex128) * len(bt))
    assert len(bt) == tspec.chirp_size(1031, 516) == 1568
    assert np.abs(b[516 : 1568 - 1030]).max() < 1e-5  # zero between the lags
    with pytest.raises(ValueError, match="wraps"):
        tspec.chirpz_tables(1031, 1536)


def test_chirpz_launch_plan_takes_two_frames_where_three_blocks_fit():
    """The chirp-z route's tile: ``tile_plan``'s, except that a one-frame
    tile becomes two frames where two fit a third of the shared memory
    (1,210 < M <= 1,614; 1,031's 1,568 points among them)."""
    assert tspec.chirpz_launch_plan(1568) == (2, 16 * tspec.tile_elems(1568, 2)) == (2, 75264)
    for M in (320, 1210, 1614, 1616, 2240, 7264):
        plan, base = tspec.chirpz_launch_plan(M), tspec.tile_plan(M)
        two = 1210 < M <= 1614
        assert plan == ((2, 16 * tspec.tile_elems(M, 2)) if two else base), M
        assert plan.smem_bytes <= tspec.SMEM_LIMIT


@pytest.mark.parametrize("n_fft", [7681, 15362])
def test_rader_window_is_the_window_in_gather_order(n_fft):
    """The global Rader route's window table: the window's own float32
    values at the gathered samples, point by point (pairs for an even
    n_fft), so the kernel reads it in order."""
    w = tspec.analysis_window("hann", n_fft)
    gin = tspec.rader_tables(n_fft)[0][0].astype(np.int64)
    got = tspec.rader_window(n_fft)
    want = w[gin] if n_fft % 2 else np.stack([w[2 * gin], w[2 * gin + 1]], -1).reshape(-1)
    assert got.dtype == np.float32 and np.array_equal(got, want)
    assert np.array_equal(tspec.rader_window(n_fft, "rect"), np.ones_like(want))


@pytest.mark.parametrize("n, M", [(1031, 2240), (1031, 1600), (2183, 4096)])
def test_pruned_chirpz_model_at_other_sizes(n, M):
    """The odd chirp-z transform over any size from L + F - 1 on (the
    unpruned 2,240 at 1,031 among them, which comparisons force) gives
    ``numpy.fft.rfft`` within 1e-6 of the maximum."""
    rng = np.random.default_rng(M)
    frames = rng.standard_normal((3, n)).astype(np.float32)
    frames[1] *= 1e-3
    frames = frames * tspec.kernel_tables(n)[0][None, :]
    got = chirpz_model(frames.astype(np.complex64), n, M)
    ref = np.fft.rfft(frames.astype(np.float64), axis=-1)
    for f in range(3):
        assert np.abs(got[f] - ref[f]).max() <= 1e-6 * np.abs(ref[f]).max(), f


@pytest.mark.parametrize("n", [296, 2062, 14530])
def test_k8_chirpz_inverse_model_reconstructs_the_frame(n):
    """K8's inverse through the chirp-z transform: from X (bins 0 .. M, the
    imaginary parts of 0 and M dropped) the un-split u[k] = conj(2 Z[k]),
    its chirp-z transform and conj(.) / n give the frame back within 1e-6
    of its maximum."""
    M = n // 2
    x = np.random.default_rng(n).standard_normal((2, n)).astype(np.float32)
    X = spectrum_model(x, n)
    X[:, 0] = X[:, 0].real
    X[:, M] = X[:, M].real
    k = np.arange(M)
    xk, xr = X[:, k], X[:, M - k]
    w = _table(n)[k]
    u = np.conj((xk + np.conj(xr)) + 1j * (xk - np.conj(xr)) * np.conj(w)).astype(np.complex64)
    y = np.conj(chirpz_model(u, n)) / np.float32(n)
    back = np.stack([y.real, y.imag], axis=-1).reshape(2, n)
    assert np.abs(back - x).max() <= 1e-6 * np.abs(x).max()


def _consts(name):
    src = (CSRC / name).read_text()
    return src, {k: int(v) for k, v in re.findall(r"constexpr (?:int|long long) (k\w+) = (\d+)",
                                                  src)}


def test_plan_twins_mirror_the_sources():
    """``tile_plan``, ``four_step_plan``, ``chirp_size``, ``chunk_frames``,
    ``split_plan``, ``cluster_split`` and the routes' shared-memory layouts
    against ``four_step.cuh``, ``cluster_fft.cuh``, ``spectrogram_power.cu``,
    ``spectrogram_cluster.cu`` and ``streaming.cu``."""
    src, c = _consts("four_step.cuh")
    assert c["kOneBlockPoints"] == tspec.ONE_BLOCK_POINTS
    assert c["kBlockSmemLimit"] == tspec.SMEM_LIMIT
    assert "kChunkScratch = 1 << 25" in src and tspec.CHUNK_SCRATCH == 1 << 25
    assert "bytes <= kBlockSmemLimit / 4 || (lg == 0 && bytes <= kBlockSmemLimit)" in src
    assert "for (int d = 1; (long long)d * d <= N; ++d)" in src
    assert "const long long lo = (long long)L + K - 1 > 2 ? (long long)L + K - 1 : 2;" in src
    assert "K >= 1 && K <= L && M >= lo && seven_smooth(M)" in src
    assert "(M <= kOneBlockPoints || four_step_of(M).ok)" in src
    assert "long long c = kChunkScratch / (16LL * N);" in src
    mixed_src, mc = _consts("mixed_fft.cuh")
    assert mc["kMaxPasses"] == tspec.MIXED_MAX_PASSES
    # the fewest passes, then the smallest: 320 = 8 8 5 over 300 = 4 3 5 5
    assert [tspec.chirp_size(L) for L in (1, 2, 148, 1009, 1031, 7265, 65537)] == \
        [2, 3, 320, 2048, 2240, 15680, 134456]
    # an odd frame's F bins: from L + F - 1 on (1,546 at 1,031)
    assert [tspec.fft_shape(n)[1] for n in (1031, 1111, 2183, 9999, 65537)] == \
        [1568, 1715, 3584, 15680, 100352]
    assert all(len(tspec.mixed_radices(m)) >= 4 for m in range(2017, 2048)
               if tspec.mixed_radices(m) and set(tspec.mixed_radices(m)) <= {2, 3, 4, 5, 7, 8})
    assert tspec.four_step_plan(8192)[:2] == (64, 128)
    assert tspec.four_step_plan(134456)[:2] == (343, 392)
    assert tspec.four_step_plan(7 * 37) is None and tspec.four_step_plan(2) is None
    assert tspec.tile_plan(7264) == (1, 16 * 7266) and tspec.tile_plan(14527) is None
    assert tspec.tile_plan(300) == (8, 16 * 300 * 9) and tspec.tile_plan(2025) == (1, 16 * 2028)
    assert tspec.chunk_frames(8192, 10 ** 6) == 256 and tspec.chunk_frames(1 << 22, 5) == 1
    k1_src, _ = _consts("spectrogram_power.cu")
    assert "const long long smem = 16LL * tile_elems(n_fft, frame_tile);" in k1_src
    assert "const long long smem = 16LL * tile_elems(Mc, frame_tile);" in k1_src
    assert ("!chirp_size_takes(n_fft % 2 ? n_fft : n_fft / 2, n_fft % 2 ? n_fft / 2 + 1 : "
            "n_fft / 2,") in k1_src
    assert "!chirp_size_takes(L, even ? L : n_fft / 2 + 1, NT)" in k1_src
    # the global Rader route's scratch: two chunk buffers of R points and
    # A_0 a frame (rader_global_scratch_bytes)
    assert "const long long chunk = chunk_frames(R, frames);" in k1_src
    assert "(16LL * R + 8) * chunk > scratch_bytes" in k1_src
    assert "half ? four_step_of(R / 2) : fs" in k1_src
    # the gather reads the window by point from the permuted table
    assert "src.window = rwin;" in k1_src
    assert "at(__ldg(gin + 2 * m), 2 * m), at(__ldg(gin + 2 * m + 1), 2 * m + 1)" in src
    # the chirp-z launcher takes the tile it is given (chirpz_launch_plan)
    assert "const long long smem = 16LL * tile_elems(Mc, frame_tile);" in k1_src
    assert "16LL * tile_elems(L - 1, frame_tile) + 16LL * frame_tile + 16;" in k1_src
    assert tspec.rader_launch_plan(1009) == (2, 16 * tspec.tile_elems(1008, 2) + 32 + 16)
    assert tspec.rader_launch_plan(1031) is None and tspec.rader_launch_plan(31) is None
    (gin, qout), _ = tspec.rader_tables(1009)
    assert sorted(gin) == list(range(1, 1009)) and sorted(qout[1:]) == list(range(1008))
    # the split route: split_of mirrors split_plan (one prime above 31,
    # dividing L once; Q with a plan within one block; Rader where P - 1 has
    # a plan within one block), split_row_step split_row_plan, and the
    # launcher checks the column tile's bytes and the chirp-z size
    assert "if (d > kMaxPrime) {" in src and "if (n_big != 1) return s;" in src
    assert "s.rader = s.P - 1 <= kOneBlockPoints && mixed_plan_of(s.P - 1).n_pass > 0;" in src
    assert "s.ok = s.Q >= 2 && s.Q <= kOneBlockPoints && mixed_plan_of(s.Q).n_pass > 0;" in src
    assert "for (int lg = 8; lg > 5; --lg) {" in src and "bytes <= kBlockSmemLimit / 4" in src
    assert ("const long long smem = 16LL * tile_elems(M, col_tile) + (sp.rader ? 16LL * col_tile "
            ": 0);") in k1_src
    assert "!chirp_size_takes(sp.P, sp.P, M)" in k1_src and "M != sp.P - 1" in k1_src
    assert "const int rows = even ? sp.P : (sp.P + 1) / 2;" in k1_src
    assert "const long long chunk = chunk_frames(fs.N, frames);" in k1_src
    for L in list(range(2, 3000)) + [7005, 7265, 9999, 14026, 15362]:
        q, big = L, []
        d = 2
        while d * d <= q:  # split_of's loop
            while q % d == 0:
                big += [d] if d > 31 else []
                q //= d
            d += 1
        big += [q] if q > 31 else []
        ok = len(big) == 1 and 2 <= L // big[0] <= tspec.ONE_BLOCK_POINTS and \
            tspec.mixed_radices(L // big[0]) is not None
        rader = ok and big[0] - 1 <= tspec.ONE_BLOCK_POINTS and \
            tspec.mixed_radices(big[0] - 1) is not None
        plan = tspec.split_plan(L)
        assert (plan is not None) == (ok and (rader or tspec.chirp_size(big[0]) <=
                                              tspec.ONE_BLOCK_POINTS)), L
        assert plan is None or plan.kind == ("rader" if rader else "chirpz"), L
    for Q in (2, 5, 15, 99, 1000, 7264):
        lg = next((lg for lg in (8, 7, 6) if 16 * tspec.tile_elems(Q, 1 << lg) <=
                   tspec.SMEM_LIMIT // 4), None)
        assert tspec.split_row_plan(Q) == (tspec.tile_plan(Q) if lg is None else
                                           (1 << lg, 16 * tspec.tile_elems(Q, 1 << lg)))
    # the cluster route: cluster_split_of mirrors cluster_split (C | N1, C |
    # N2, N1 <= N2, the fewest passes, then the largest N1; the buffers'
    # strides and the tables), the launcher checks the plan's split and bytes
    cl_src, cl = _consts("cluster_fft.cuh")
    assert cl["kMaxCluster"] == max(tspec.CLUSTER_SIZES) == 8
    assert "for (int d = C; (long long)d * d <= M; d += C) {" in cl_src
    assert "if (M % d != 0 || (M / d) % C != 0) continue;" in cl_src
    assert "if (p1 + p2 <= best) {" in cl_src
    assert "s.ldc = s.nc | 1;" in cl_src and "s.ldr = s.N2 | 1;" in cl_src
    assert "const long long a = (long long)s.N1 * s.ldc, b = (long long)s.nr * s.ldr;" in cl_src
    assert "while ((1LL << (2 * s.sh)) < M) ++s.sh;" in cl_src
    assert "s.tw = s.N1 + s.N2 + (1 << s.sh) + ((M - 1) >> s.sh) + 1;" in cl_src
    assert "return 16LL * s.elems + 8LL * s.tw;" in cl_src
    assert "(long long)M * s.N2 < (1LL << 32)" in cl_src
    k1c_src, _ = _consts("spectrogram_cluster.cu")
    assert "s.N1 != N1 || cluster_smem(s) != smem_bytes || !seven_smooth(M)" in k1c_src
    for M in (7680, 10752, 14112, 16384, 47040, 61440, 3136, 2560):
        for C in tspec.CLUSTER_SIZES:
            best, n1 = None, 0
            for d in range(C, math.isqrt(M) + 1, C):  # cluster_split_of's loop
                if M % d == 0 and (M // d) % C == 0 and d >= 2:
                    p = len(tspec.mixed_radices(d)) + len(tspec.mixed_radices(M // d))
                    if best is None or p <= best:
                        best, n1 = p, d
            got = tspec.cluster_split(M, C)
            assert (got and got[0]) == (n1 or None), (M, C)
            if got:
                n2 = M // n1
                elems = max(n1 * ((n2 // C) | 1), (n1 // C) * (n2 | 1))
                sh = math.ceil(math.log2(M) / 2)
                tw = n1 + n2 + 2 ** sh + -(-M // 2 ** sh)
                assert got[2] == 16 * (elems + elems % 2) + 8 * tw, (M, C)
    k8_src, k8 = _consts("streaming.cu")
    assert "return 16 * tile_elems(Mc, slots) + 4 * slots * K;" in k8_src
    assert "chirp_size_takes(M, M, c->chirp_n)" in k8_src
    assert "return 16LL * N * chunk_frames(N, frames) + 8LL * hop;" in k8_src
    assert "return (K + kMaxWalkThreads - 1) / kMaxWalkThreads;" in k8_src
    assert k8["kMaxWalkThreads"] == 1024 and k8["kFrames"] == 4
    assert "w.narrow = c.K <= kMaxWalkThreads && 4 * walk_floats(c, kFrames) <= kSmemLimit;" \
        in k8_src
    assert ts.k8_chirpz_slots(296, 149) == 16 and ts.k8_chirpz_slots(9000, 4501) == 0
    assert ts.k8_global_scratch_bytes(16384, 64) == 16 * 8192 * 64 + 8 * 8192


@pytest.mark.parametrize("K, taps, snr, want", [
    (129, 3, 0, (True, 4, 1)), (1025, 3, 0, (False, 4, 2)), (4097, 3, 4097, (False, 1, 5)),
    (5027, 3, 5027, (False, 1, 5)), (8193, 3, 8193, (False, 1, 9))])
def test_k8_walk_plan(K, taps, snr, want):
    """One bin a thread at four frames a round on the main path's widths;
    ceil(K / 1,024) bins a thread past 1,024; fewer frames a round as the
    rows grow, and a global scratch where one frame's rows do not fit."""
    w = ts.k8_walk_plan(K, taps, snr)
    assert (w.narrow, w.frames, w.bins_per_thread) == want
    assert w.threads <= 1024 and w.threads * w.bins_per_thread >= K
    rows = 4 * ts.k8_walk_floats(K, taps, snr, w.frames)
    assert (w.smem, w.scratch) == ((rows, 0) if rows <= ts._K8_SMEM_LIMIT
                                   else (0, rows // 4))


def test_k1_route_is_total():
    """Every n_fft from 1 to 20,000 and the routes' large sizes take a route
    at hop n_fft / 2 and at hop 1, and none the direct DFT; a prime complex
    length takes a Rader route wherever L - 1 has one; past one block's
    chirp-z size the rest take the split route wherever L splits, else the
    cluster route wherever its plan reaches."""
    routes = set()
    for n in list(range(1, 20001)) + [32768, 60000, 65536, 65537, 131074]:
        for hop in (max(1, n // 2), 1):
            r = tspec.k1_route(n, hop)
            assert r != "dft", (n, hop)
            routes.add(r)
        L, N = tspec.fft_shape(n)
        assert N == L or tspec.mixed_radices(L) is None or tspec.four_step_plan(L) is None
        assert N <= tspec.ONE_BLOCK_POINTS or tspec.four_step_plan(N) is not None
        if tspec.rader_global_takes(L):
            assert tspec.k1_route(n, max(1, n // 2)) == "rader_global", n
        elif N != L and N > tspec.ONE_BLOCK_POINTS and tspec.rader_launch_plan(L) is None:
            split = tspec.split_plan(L) is not None
            cluster = tspec.cluster_plan(L, tspec.chirp_bins(n)) is not None
            assert tspec.k1_route(n, max(1, n // 2)) == (
                "split" if split else "cluster" if cluster else "global"), n
    assert routes == {"fft", "mixed", "mixed_odd", "rader", "rader_global", "chirpz", "split",
                      "cluster", "global"}
    assert set(tspec.K1_ROUTES) == routes | {"dft"}


@pytest.mark.parametrize("n_fft", [2, 4, 6, 296, 386, 2062, 4096, 8192, 10000, 10240, 16384,
                                   30002, 65536])
def test_k8_takes_what_the_jax_package_runs(n_fft):
    """Any even n_fft = 2 hop with all n_fft / 2 + 1 bins as band bins, as
    many SNR columns and taps: no refusal, a pass other than the DFT; what
    the JAX package refuses is refused."""
    F = n_fft // 2 + 1
    assert ts.k8_check_geometry(n_fft, n_fft // 2, F, 9, F) is None
    assert ts.k8_route(n_fft) in ("fft", "mixed", "chirpz", "global")
    for bad in ((n_fft, n_fft // 2 + 1, 1, 3, 0), (n_fft, n_fft // 2, 0, 3, 0),
                (n_fft, n_fft // 2, F + 1, 3, 0), (n_fft, n_fft // 2, F, 3, F + 1),
                (n_fft + 1, n_fft // 2, 1, 3, 0)):
        with pytest.raises(ValueError, match="streaming_suppressor"):
            ts.k8_check_geometry(*bad)


@pytest.mark.parametrize("n_fft, hop", [(296, 148), (385, 192), (1009, 504), (1031, 515),
                                        (9999, 4999)])
def test_jax_and_port_spectrogram_agree(n_fft, hop):
    """The JAX package's ``spectrogram_power`` (its rfft path: the Pallas
    kernel takes only n_fft = 2 hop, n_fft % 128 = 0) against the port's on
    the CPU, within 1e-5 of the maximum (9,999/4,999: the CPU path at a size
    the card runs on the split route, which ``split_model`` and the card's
    own check hold against the reference)."""
    rng = np.random.default_rng(n_fft)
    x = rng.standard_normal((3, 6000)).astype(np.float32)
    x[1] *= 1e-3
    ref = np.asarray(jspec.spectrogram_power(jnp.asarray(x), n_fft=n_fft, hop=hop))
    got = tspec.spectrogram_power(torch.from_numpy(x), n_fft=n_fft, hop=hop).numpy()
    assert got.shape == ref.shape == (3, n_fft // 2 + 1, 1 + 6000 // hop)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
