"""The mixed-radix FFT of K1's mixed route and K8's mixed frame pass
(``csrc/mixed_fft.cuh``), which runs only on the card: a NumPy model of
its plan, run as the kernel runs it (the same passes in the same radix
order, the same twiddle indices into the float32 host table, the odd
primes' symmetric butterfly, the real split), held against
``numpy.fft.rfft`` at every frame size of the TPU kernel's geometry set
(``n_fft = 128 m``, ``m <= 32``) and at sizes users type; and the plan's
Python twins against the constants of the CUDA sources, with the routes of
K1 and K8 that choose it.
"""

import re
from pathlib import Path

import numpy as np
import pytest

from audio_processing_tools_tpu_torch.models import streaming as ts
from audio_processing_tools_tpu_torch.ops import spectrogram as tspec

CSRC = Path(tspec.__file__).resolve().parent.parent / "csrc"


def _table(n):
    """K1's and K8's twiddle table e^{-2 pi i j / n} as complex64."""
    tw = tspec.kernel_tables(n)[1]
    return (tw[:, 0] + 1j * tw[:, 1]).astype(np.complex64)


def _butterfly(v, R, table, n):
    """``butterfly<R>`` on v (frames, R, butterflies): a register DFT for
    2, 4 and 8; for an odd R the symmetric form of ``dft_odd`` with
    cs[m] = table[m n / R]."""
    if R % 2 == 0:
        return np.fft.fft(v.astype(np.complex128), axis=1).astype(np.complex64)
    H = R // 2
    cs = table[np.arange(H + 1) * (n // R)]
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


def mixed_fft_model(z, n):
    """``mixed_fft``: the M = n / 2 point transform of each row of z
    (frames, M) complex64, pass by pass as the kernel runs it."""
    M = n // 2
    table = _table(n)
    NS = 1
    for R in tspec.mixed_radices(M):
        nb = M // R
        b = np.arange(nb)
        q, k = b // NS, b % NS
        r = np.arange(R)[:, None]
        v = z[:, b[None, :] + r * nb]                      # (frames, R, nb)
        tw = table[(n // (NS * R)) * k[None, :] * r]        # (R, nb)
        v = np.where(k[None, None, :] > 0, v * tw[None], v).astype(np.complex64)
        v = _butterfly(v, R, table, n)
        out = np.empty_like(z)
        out[:, (q * NS * R + k)[None, :] + r * NS] = v
        z, NS = out, NS * R
    return z


def rfft_model(frames, n):
    """X[k], k <= n / 2, of each windowed frame (frames, n) float32, as the
    mixed route forms it: the packing, the transform and the real split."""
    M = n // 2
    z = (frames[:, 0::2] + 1j * frames[:, 1::2]).astype(np.complex64)
    Z = mixed_fft_model(z, n)
    k = np.arange(M)
    zk, zm = Z[:, k], Z[:, np.where(k == 0, 0, M - k)]
    w = _table(n)[k]
    a = 0.5 * (zk + np.conj(zm))
    dd = 0.5 * (zk - np.conj(zm))
    X = a - 1j * w * dd
    last = (Z[:, 0].real - Z[:, 0].imag)[:, None]
    return np.concatenate([X, last], axis=1)


SIZES = [128 * m for m in range(1, 33)] + [400, 480, 500, 1000]


@pytest.mark.parametrize("n", SIZES)
def test_mixed_fft_model_matches_numpy_rfft(n):
    """The model of the kernel's plan gives ``numpy.fft.rfft`` of Hann-
    windowed frames within 1e-6 of the spectrum's maximum."""
    rng = np.random.default_rng(n)
    frames = rng.standard_normal((3, n)).astype(np.float32)
    frames[1] *= 1e-3  # a quiet frame beside loud ones
    frames = frames * tspec.kernel_tables(n)[0][None, :]
    got = rfft_model(frames, n)
    ref = np.fft.rfft(frames.astype(np.float64), axis=-1)
    for f in range(3):
        assert np.abs(got[f] - ref[f]).max() <= 1e-6 * np.abs(ref[f]).max(), f


@pytest.mark.parametrize("n", [384, 2048, 1000])
def test_k8_mixed_inverse_model_reconstructs_the_frame(n):
    """K8's inverse through the same transform: from X (bins 0 .. M, the
    imaginary parts of 0 and M dropped), 2 Z[k] = (X[k] + conj X[M-k]) +
    i (X[k] - conj X[M-k]) e^{2 pi i k / n}, then conj(FFT_M(conj 2Z)) / n
    gives the frame back within 1e-6 of its maximum."""
    M = n // 2
    x = np.random.default_rng(n).standard_normal((2, n)).astype(np.float32)
    X = rfft_model(x, n)
    X[:, 0] = X[:, 0].real
    X[:, M] = X[:, M].real
    k = np.arange(M)
    xk, xr = X[:, k], X[:, M - k]
    w = _table(n)[k]
    a, dd = xk + np.conj(xr), xk - np.conj(xr)
    two_z = a + 1j * dd * np.conj(w)
    y = np.conj(mixed_fft_model(np.conj(two_z).astype(np.complex64), n)) / np.float32(n)
    back = np.stack([y.real, y.imag], axis=-1).reshape(2, n)
    assert np.abs(back - x).max() <= 1e-6 * np.abs(x).max()


def _consts(name):
    src = (CSRC / name).read_text()
    return src, {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}


def test_mixed_plan_twins_mirror_the_sources():
    """``mixed_radices``, the tile buffers and both kernels' shared-memory
    layouts against ``mixed_fft.cuh``, ``spectrogram_power.cu`` and
    ``streaming.cu``."""
    src, consts = _consts("mixed_fft.cuh")
    assert consts["kMaxPrime"] == tspec.MIXED_MAX_PRIME
    assert "while (q % 8 == 0)" in src and "if (q % 4 == 0)" in src
    assert "for (int f = 3; f <= kMaxPrime && q > 1; f += 2)" in src
    assert "return (rows * tile_ld(ft) + (ft == 1 ? 2 : 0) + 1) & ~1;" in src
    assert "return ft == 1 ? 1 : ft + 1;" in src
    assert all(len(tspec.mixed_radices(n // 2)) <= consts["kMaxPasses"] for n in SIZES)
    assert [tspec.mixed_radices(M) for M in (192, 200, 250, 1024, 1984, 1, 37, 74)] == \
        [(8, 8, 3), (8, 5, 5), (2, 5, 5, 5), (8, 8, 8, 2), (8, 8, 31), None, None, None]
    k1_src, k1 = _consts("spectrogram_power.cu")
    assert k1["kMixedMaxTile"] == tspec.MIXED_MAX_TILE
    assert "return 16 * (size_t)tile_elems(n_fft / 2, frame_tile);" in k1_src
    assert tspec.mixed_launch_plan(384) == (16, 16 * ((192 * 17 + 1) // 2 * 2))
    k8_src, k8 = _consts("streaming.cu")
    assert "return 16 * tile_elems(n_fft / 2 + 1, slots) + 4 * slots * K;" in k8_src
    assert "for (int slots = kMinSlots; slots >= 2; slots /= 2)" in k8_src
    assert k8["kMinSlots"] == 16
    assert ts.k8_mixed_slots(2048, 1025) == 8 and ts.k8_mixed_slots(384, 193) == 16


@pytest.mark.parametrize("n", SIZES)
def test_mixed_launch_plan_fits(n):
    """Every size of the TPU kernel's set and the typed ones: a plan, a
    power-of-two tile whose block fits a quarter of the limit (four blocks
    an SM) or holds one frame, and K1 takes the mixed route wherever the
    power-of-two FFT does not."""
    ft, smem = tspec.mixed_launch_plan(n)
    assert ft & (ft - 1) == 0 and 1 <= ft <= tspec.MIXED_MAX_TILE
    assert smem == tspec._mixed_smem(n, ft) <= (tspec.SMEM_LIMIT // 4 if ft > 1
                                                else tspec.SMEM_LIMIT)
    assert ft == 1 or tspec._mixed_smem(n, 2 * ft) > tspec.SMEM_LIMIT // 4 or ft == 32
    assert tspec.k1_route(n, n // 2) == ("fft" if n in tspec.N_FFTS else "mixed")
    assert ts.k8_route(n) == ("fft" if n in tspec.N_FFTS else "mixed")
    assert ts.k8_check_geometry(n, n // 2, n // 2 + 1, 9, 8) is None
