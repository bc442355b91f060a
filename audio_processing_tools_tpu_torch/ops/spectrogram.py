"""Power spectrogram through the hand-written CUDA kernel K1.

Counterpart of ``audio_processing_tools_tpu/ops/spectrogram.py:155-224``,
whose Pallas kernel ``_power_kernel`` (``:77-96``) fuses framing, the Hann
window, the real DFT and the power into one pass.  Here that kernel is
``csrc/spectrogram_power.cu``, a fused shared-memory FFT; its plain version
is :func:`~audio_processing_tools_tpu_torch.ops.stft.stft_power`.

A CPU tensor takes the plain version.  A CUDA tensor launches the kernel or
raises: there is no fallback.  The kernel's route comes from the geometry
alone (:func:`k1_route`): the power-of-two FFT for n_fft 64 to 1024 at a
hop that is a multiple of 4 (the main path's 256/128); for every other
n_fft, the transform of its complex length L (n_fft / 2 packed in pairs,
or n_fft for an odd n_fft) by the mixed-radix FFT (``csrc/mixed_fft.cuh``)
where L has no prime factor above :data:`MIXED_MAX_PRIME` (the mixed route
for an even n_fft, the TPU kernel's sizes ``128 m`` among them; the odd
mixed route for an odd one), else, for a prime L whose L - 1 has such
factors, by Rader's convolution over L - 1 points (the Rader route; past
one block the global Rader route, both transforms four-step FFTs), else
by the chirp-z transform over a 7-smooth size (:func:`chirp_size`); and
past :data:`ONE_BLOCK_POINTS` points either
transform as a four-step FFT through device memory (the global route,
``csrc/four_step.cuh``), except where L = P Q splits at its one prime
factor P above 31 (the split route, :func:`split_plan`: P's transform by
Rader or the chirp-z transform in one block a column, then the rows' mixed
FFTs of Q points), and except where a chirp-z size that does not split fits
a thread-block cluster of up to 8 blocks (the cluster route,
:func:`cluster_plan`, ``csrc/spectrogram_cluster.cu``: the whole chirp-z
transform of a frame on chip, the blocks exchanging through distributed
shared memory).  Every n_fft >= 1 and hop >= 1 takes one.  The
direct DFT (the TPU kernel's window-and-DFT product, ``csrc/dft.cuh``) is
a route only comparisons force.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from audio_processing_tools_tpu_torch import _kernels
from audio_processing_tools_tpu_torch.ops._device import device_constant
from audio_processing_tools_tpu_torch.ops.stft import stft_power
from audio_processing_tools_tpu_torch.ops.windows import analysis_window

#: threads per block of the kernel
THREADS = 256
#: dynamic shared memory one block may use on Hopper
SMEM_LIMIT = 232_448
#: n_fft the kernel supports
N_FFTS = (64, 128, 256, 512, 1024)


class LaunchPlan(NamedTuple):
    frame_tile: int  # frames per work item
    smem_bytes: int  # dynamic shared memory per block


#: the largest n_fft of the DFT route, which only comparisons force: one
#: frame's samples in shared memory, the last plan of ``dft_plan_for`` in the
#: kernel's source
DFT_MAX_N_FFT = SMEM_LIMIT // 4


#: the largest odd prime factor of n_fft / 2 the mixed route takes
#: (``kMaxPrime`` of ``csrc/mixed_fft.cuh``)
MIXED_MAX_PRIME = 31
#: passes a plan holds (``kMaxPasses``)
MIXED_MAX_PASSES = 16
#: frames a block of the mixed route holds at most (``kMixedMaxTile``)
MIXED_MAX_TILE = 32
#: the largest transform a route runs in one block a frame (``kOneBlockPoints``
#: of ``csrc/four_step.cuh``; such a block takes half the shared memory a
#: block may use); past it the four-step split runs it through device memory
ONE_BLOCK_POINTS = 7264
#: bytes of the global route's two chunk buffers together (``kChunkScratch``)
CHUNK_SCRATCH = 1 << 25


def mixed_radices(M: int):
    """The passes of the mixed route's M-point transform, in order
    (``mixed_plan_of`` in ``csrc/mixed_fft.cuh``): radix 8 while 8 divides
    the power of two, then one radix 4 or 2, then the odd primes ascending;
    ``None`` where ``M < 2``, an odd prime factor passes
    :data:`MIXED_MAX_PRIME` or the odd primes would take the plan past
    :data:`MIXED_MAX_PASSES`."""
    if M < 2:
        return None
    radices, q = [], M
    while q % 8 == 0:
        radices.append(8)
        q //= 8
    if q % 4 == 0:
        radices.append(4)
        q //= 4
    elif q % 2 == 0:
        radices.append(2)
        q //= 2
    for f in range(3, MIXED_MAX_PRIME + 1, 2):
        while q % f == 0:
            if len(radices) == MIXED_MAX_PASSES:
                return None
            radices.append(f)
            q //= f
    return tuple(radices) if q == 1 else None


def tile_elems(rows: int, frame_tile: int) -> int:
    """float2 of one tile buffer (``tile_elems``): ``rows`` points of the
    tile's frames at row stride ``frame_tile + 1`` (1 and two more points
    for a single frame: ``tile_ld``), rounded up to even."""
    if frame_tile == 1:
        return (rows + 3) // 2 * 2
    return (rows * (frame_tile + 1) + 1) // 2 * 2


def _mixed_smem(n_fft: int, frame_tile: int) -> int:
    """Shared memory of one block of the mixed route, as ``mixed_smem_for``
    in the kernel's source: two tile buffers of n_fft / 2 points (the
    samples are staged in the second)."""
    return 16 * tile_elems(n_fft // 2, frame_tile)


def tile_plan(n: int) -> Optional[LaunchPlan]:
    """The frame tile and shared memory of a block that transforms ``n``
    points a frame in two tile buffers (``step_plan`` of
    ``csrc/four_step.cuh``): the largest power of two up to
    :data:`MIXED_MAX_TILE` frames whose block takes at most a quarter of
    :data:`SMEM_LIMIT` (four blocks an SM), else one frame up to the whole
    limit; ``None`` where one frame does not fit.  The mixed route's tile
    (``n = n_fft / 2``) was the fastest at 384, 400, 640, 768 and 2,048 on
    an H100 80GB HBM3 at 700 W (``tools/time_mixed_tiles.py``; at 384/192
    and 128 x 10 s, 0.1280 ms with 16 frames a block against 0.1740 with
    32)."""
    for ft in (32, 16, 8, 4, 2, 1):
        smem = 16 * tile_elems(n, ft)
        if smem <= SMEM_LIMIT // 4 or (ft == 1 and smem <= SMEM_LIMIT):
            return LaunchPlan(ft, smem)
    return None


def chirpz_launch_plan(M: int) -> Optional[LaunchPlan]:
    """The chirp-z route's frame tile and shared memory for M points a
    transform: :func:`tile_plan` of M, except where that holds one frame and
    two fit a third of :data:`SMEM_LIMIT` (three blocks an SM; 1,210 < M <=
    1,614): two frames, whose odd row stride keeps the first passes'
    strided stores free of bank conflicts (at 1,031/515 and 128 x 10 s over
    1,568 points, 0.7814 ms against 0.8695 with one frame and 1.1004 with
    four, ``tools/time_chirp_sizes.py --tiles``, H100 80GB HBM3, 700 W)."""
    plan = tile_plan(M)
    two = 16 * tile_elems(M, 2)
    if plan is not None and plan.frame_tile == 1 and two <= SMEM_LIMIT // 3:
        return LaunchPlan(2, two)
    return plan


def mixed_launch_plan(n_fft: int) -> LaunchPlan:
    """The mixed route's frame tile and shared memory, :func:`tile_plan` of
    n_fft / 2.  Raises ``ValueError`` where even one frame does not fit."""
    plan = tile_plan(n_fft // 2)
    if plan is None:
        raise ValueError(f"the mixed route's frame of n_fft {n_fft} does not fit shared memory")
    return plan


def mixed_route_takes(n_fft: int) -> bool:
    """Whether the mixed FFT takes an ``n_fft`` (any hop): even, at least 4,
    its half with a plan (:func:`mixed_radices`) and one frame's block in
    :data:`SMEM_LIMIT`."""
    return (n_fft >= 4 and n_fft % 2 == 0 and mixed_radices(n_fft // 2) is not None
            and _mixed_smem(n_fft, 1) <= SMEM_LIMIT)


class FourStepPlan(NamedTuple):
    N1: int  # points of a column transform
    N2: int  # points of a row transform
    col: LaunchPlan  # columns a block
    row: LaunchPlan  # rows a block


@functools.lru_cache(maxsize=None)
def four_step_plan(N: int) -> Optional[FourStepPlan]:
    """The global route's split of an N-point transform (``four_step_of``
    of ``csrc/four_step.cuh``): N1 the largest divisor of N up to sqrt(N),
    N2 = N / N1, each transform with a plan and a tile
    (:func:`tile_plan`); ``None`` where the split is not valid."""
    n1 = max(d for d in range(1, math.isqrt(N) + 1) if N % d == 0) if N >= 1 else 1
    n2 = N // max(n1, 1)
    col, row = tile_plan(n1), tile_plan(n2)
    if (N < 4 or n1 < 2 or mixed_radices(n1) is None or mixed_radices(n2) is None
            or col is None or row is None):
        return None
    return FourStepPlan(n1, n2, col, row)


def _seven_smooth_between(lo: int, hi: int):
    """The numbers in [lo, hi) whose only prime factors are 2, 3, 5 and 7."""
    out, p7 = [], 1
    while p7 < hi:
        p5 = p7
        while p5 < hi:
            p3 = p5
            while p3 < hi:
                m = p3
                while m < hi:
                    if m >= lo:
                        out.append(m)
                    m *= 2
                p3 *= 3
            p5 *= 5
        p7 *= 7
    return out


@functools.lru_cache(maxsize=None)
def chirp_size(L: int, K: Optional[int] = None) -> int:
    """The chirp-z transform's size for a complex length ``L`` of which the
    first ``K`` bins are wanted (all L by default; an odd n_fft's power
    reads F = n_fft / 2 + 1 of them): among the sizes M from max(2, L + K -
    1), where the lags of those bins stop wrapping, up to 4L whose only
    prime factors are 2, 3, 5 and 7 (the cheapest radices; a power of two
    always lies there), the one with the fewest mixed-radix passes
    (:func:`mixed_radices`), the smallest of those, whose transform one
    block holds (M <= :data:`ONE_BLOCK_POINTS`) or the four-step split takes
    (:func:`four_step_plan`).  Passes, not points, set the time: on an
    H100 80GB HBM3 at 700 W and 128 x 10 s, 1,009/504 took 1.3379 ms over
    the smallest such size, 2,025 (six passes), and 1.1864 over 2,048
    (four); 296/148 0.4963 over 300 (four) and 0.4047 over 320 (three)
    (``tools/time_chirp_sizes.py``).
    ``csrc/four_step.cuh::chirp_size_takes`` checks the launcher's size.
    Raises ``ValueError`` past the split's reach (M above 7,264 squared)."""
    K = L if K is None else K
    lo = max(2, L + K - 1)
    sizes = sorted(_seven_smooth_between(lo, max(4 * L, 8)),
                   key=lambda m: (len(mixed_radices(m)), m))
    for m in sizes:
        if m <= ONE_BLOCK_POINTS or (m <= ONE_BLOCK_POINTS ** 2 and four_step_plan(m) is not None):
            return m
    raise ValueError(f"no chirp-z size for a complex length of {L} points")


@functools.lru_cache(maxsize=None)
def fft_shape(n_fft: int) -> Tuple[int, int]:
    """``(L, N)``: the complex length of an ``n_fft`` frame's transform (n_fft
    / 2, packed in pairs, for an even n_fft; n_fft for an odd one) and the
    size of the transform that computes it: L itself where L has a plan
    (:func:`mixed_radices`) that one block or the four-step split takes,
    else the chirp-z size (:func:`chirp_size` of L and the bins the power
    reads, :func:`chirp_bins`)."""
    L = n_fft // 2 if n_fft % 2 == 0 else n_fft
    if mixed_radices(L) is not None and (L <= ONE_BLOCK_POINTS or four_step_plan(L) is not None):
        return L, L
    return L, chirp_size(L, chirp_bins(n_fft))


def chirp_bins(n_fft: int) -> int:
    """The bins of the chirp-z transform K1's power reads: every one of the
    L = n_fft / 2 of an even n_fft (its real split pairs bin k with L - k),
    the F = n_fft / 2 + 1 of the half spectrum of an odd one."""
    return n_fft // 2 if n_fft % 2 == 0 else n_fft // 2 + 1


def _is_prime(n: int) -> bool:
    return n >= 2 and all(n % d for d in range(2, math.isqrt(n) + 1))


def rader_launch_plan(L: int) -> Optional[LaunchPlan]:
    """The Rader route's frame tile and shared memory for a prime complex
    length L (``apt_spectrogram_power_rader``): two float2 a frame, two tile
    buffers of L - 1 points and 16 bytes, by :func:`tile_plan`'s rule; ``None``
    where L is not such a prime (above :data:`MIXED_MAX_PRIME`, L - 1 with a
    plan of at most :data:`ONE_BLOCK_POINTS` points) or one frame does not
    fit."""
    if not (MIXED_MAX_PRIME < L <= ONE_BLOCK_POINTS + 1 and _is_prime(L)
            and mixed_radices(L - 1) is not None):
        return None
    for ft in (32, 16, 8, 4, 2, 1):
        smem = 16 * tile_elems(L - 1, ft) + 16 * ft + 16
        if smem <= SMEM_LIMIT // 4 or (ft == 1 and smem <= SMEM_LIMIT):
            return LaunchPlan(ft, smem)
    return None


@functools.lru_cache(maxsize=8)
def _rader_tables_of(L: int):
    """Rader's host tables for a prime L (:func:`rader_tables`)."""
    R = L - 1
    factors = {d for d in range(2, R + 1) if R % d == 0 and _is_prime(d)}
    g = next(g for g in range(2, L) if all(pow(g, R // f, L) != 1 for f in factors))
    gin = np.array([pow(g, q, L) for q in range(R)], np.int64)
    qout = np.zeros(L, np.int64)
    qout[gin[(-np.arange(R)) % R]] = np.arange(R)  # g^-q = gin[-q mod R]
    b = np.exp(-2j * np.pi * gin[(-np.arange(R)) % R].astype(np.float64) / L)
    bt = np.fft.fft(b) / R
    ang = -2.0 * np.pi * np.arange(R, dtype=np.float64) / R
    return ((gin.astype(np.int32), qout.astype(np.int32)),
            (_pairs(bt), _pairs(np.cos(ang) + 1j * np.sin(ang))))


def _pairs(z) -> np.ndarray:
    """Complex values as float32 (re, im) pairs."""
    return np.stack([z.real, z.imag], axis=-1).astype(np.float32)


def rader_tables(n_fft: int):
    """The Rader route's host tables for an n_fft whose complex length L is a
    prime (:func:`rader_launch_plan`), g the smallest primitive root mod L:
    ``(gin, qout)`` int32, gin[q] = g^q mod L (q < L - 1) and qout[k] = q
    with g^-q = k mod L (qout[0] = 0, unused); and ``(bt, rtab)`` float32
    (re, im) pairs, built in float64: Bt = FFT(b) / (L - 1) of b_q =
    e^{-2 pi i g^-q / L}, and e^{-2 pi i j / (L - 1)}."""
    return _rader_tables_of(n_fft // 2 if n_fft % 2 == 0 else n_fft)


def rader_global_takes(L: int) -> bool:
    """Whether the global Rader route takes a complex length L: a prime
    above :data:`MIXED_MAX_PRIME` whose R = L - 1 passes
    :data:`ONE_BLOCK_POINTS` and has a four-step split
    (:func:`four_step_plan`; 65,537: 256 x 256)."""
    return (L - 1 > ONE_BLOCK_POINTS and L > MIXED_MAX_PRIME and _is_prime(L)
            and four_step_plan(L - 1) is not None)


def rader_global_scratch_bytes(L: int, frames: int) -> int:
    """Bytes of the global Rader route's scratch: two chunk buffers of R = L
    - 1 points a frame and A_0 (8 bytes) a frame, :func:`chunk_frames` of
    R."""
    return (16 * (L - 1) + 8) * chunk_frames(L - 1, frames)


def rader_window(n_fft: int, window: str = "hann") -> np.ndarray:
    """The window in the global Rader route's gather order (its Source reads
    point q's window by q): w[gin[q]] for an odd n_fft, (w[2 gin[q]], w[2
    gin[q] + 1]) for an even one, gin of :func:`rader_tables`; float32, the
    window's own values."""
    w = analysis_window(window, n_fft)
    gin = rader_tables(n_fft)[0][0].astype(np.int64)
    return w[gin] if n_fft % 2 else np.stack([w[2 * gin], w[2 * gin + 1]], axis=-1).reshape(-1)


#: blocks of a thread-block cluster the cluster route takes (8 is the
#: portable maximum; ``kMaxCluster`` of ``csrc/cluster_fft.cuh``)
CLUSTER_SIZES = (1, 2, 4, 8)


class ClusterPlan(NamedTuple):
    C: int  # blocks of a cluster, one frame a cluster
    M: int  # the chirp-z size
    N1: int  # points of a column transform (C | N1)
    N2: int  # points of a row transform (C | N2, N1 <= N2)
    smem_bytes: int  # dynamic shared memory of a block: two buffers and the tables


@functools.lru_cache(maxsize=None)
def cluster_split(M: int, C: int) -> Optional[Tuple[int, int, int]]:
    """``(N1, N2, smem_bytes)``: the cluster route's split of an M-point
    transform over C blocks (``cluster_split_of`` of ``csrc/cluster_fft.cuh``):
    among N1 N2 = M with C | N1, C | N2 and N1 <= N2, the fewest passes of
    the two transforms together, then the largest N1; each block holds N2 /
    C columns of N1 points (row stride N2 / C, made odd) and N1 / C rows of
    N2 points (row stride N2, made odd) in two buffers of the larger count,
    rounded up to even, then its twiddle tables, N1 + N2 + 2^sh + ceil(M /
    2^sh) float2 (4^sh >= M: the four-step twiddle as two factors).  ``None``
    where no such split has a plan (or M N2 reaches 2^32, past the kernel's
    division by multiplication)."""
    best, n1 = None, 0
    for d in range(C, math.isqrt(M) + 1, C):
        if M % d or (M // d) % C:
            continue
        r1, r2 = mixed_radices(d), mixed_radices(M // d)
        if r1 is None or r2 is None:
            continue
        if best is None or len(r1) + len(r2) <= best:
            best, n1 = len(r1) + len(r2), d
    if not n1:
        return None
    n2 = M // n1
    if M * n2 >= 1 << 32:
        return None
    elems = max(n1 * ((n2 // C) | 1), (n1 // C) * (n2 | 1))
    sh = 0
    while 4 ** sh < M:
        sh += 1
    tables = n1 + n2 + (1 << sh) + ((M - 1) >> sh) + 1
    return n1, n2, 16 * (elems + (elems & 1)) + 8 * tables


@functools.lru_cache(maxsize=None)
def cluster_plan(L: int, K: Optional[int] = None, C: Optional[int] = None) -> Optional[ClusterPlan]:
    """The cluster route's plan for the chirp-z transform of a complex length
    ``L`` whose first ``K`` bins are wanted (all L by default): C the
    smallest of :data:`CLUSTER_SIZES` whose blocks, one an SM, hold two
    buffers of M / C points and their tables (:func:`cluster_split`'s bytes
    within :data:`SMEM_LIMIT`); M a 7-smooth size from max(2, L + K - 1) up to 4L
    with C^2 | M (C divides both N1 and N2), as :func:`chirp_size` picks: the
    fewest passes (here the two transforms' of the split the kernel runs),
    then the smallest.  The smallest C, because every cluster size that
    holds a geometry was slower than the next smaller one (7,013/3,506 at 128
    x 10 s: 1.1417 ms with one block, 1.8244 / 2.7424 / 4.6420 with clusters
    of 2 / 4 / 8; H100 80GB HBM3, 700 W, ``tools/time_chirp_sizes.py
    --split``).  ``C`` forces a cluster size (the CPU models run small sizes
    at every C).  ``None`` where no size fits a cluster of 8."""
    K = L if K is None else K
    lo = max(2, L + K - 1)
    sizes = _seven_smooth_between(lo, max(4 * L, 8))
    for c in CLUSTER_SIZES if C is None else (C,):
        cap = SMEM_LIMIT // 16 * c  # M / C points a block: at most this many
        best = None
        for m in sorted((m for m in sizes if m % (c * c) == 0 and m <= cap),
                        key=lambda m: (len(mixed_radices(m)), m)):
            # a split runs at least M's own passes: stop past the best found
            if best is not None and len(mixed_radices(m)) > best[0]:
                break
            sp = cluster_split(m, c)
            if sp is None or sp[2] > SMEM_LIMIT:
                continue
            n1, n2 = sp[0], sp[1]
            key = (len(mixed_radices(n1)) + len(mixed_radices(n2)), m)
            if best is None or key < best[:2]:
                best = (*key, ClusterPlan(c, m, n1, n2, sp[2]))
        if best is not None:
            return best[2]
    return None


def chunk_frames(N: int, frames: int) -> int:
    """Frames a chunk of the global route holds (``chunk_frames``): as many
    as two buffers of N points each hold within :data:`CHUNK_SCRATCH`, at
    least one, at most ``frames``."""
    return min(max(1, CHUNK_SCRATCH // (16 * N)), frames)


def k1_route(n_fft: int, hop: int) -> str:
    """K1's route for a geometry, from :func:`fft_shape`'s ``(L, N)``:

    * ``"fft"``: a power-of-two n_fft in :data:`N_FFTS` at a hop that is a
      multiple of 4 (the power-of-two shared-memory FFT, :func:`launch_plan`);
    * ``"mixed"``: an even n_fft with N = L (the half-length mixed-radix FFT,
      :func:`mixed_launch_plan`);
    * ``"mixed_odd"``: an odd n_fft with N = L (the whole frame's mixed-radix
      FFT, :func:`tile_plan` of n_fft);
    * ``"rader"``: L a prime above :data:`MIXED_MAX_PRIME` whose L - 1 has
      a plan (Rader's convolution over L - 1 points,
      :func:`rader_launch_plan`);
    * ``"rader_global"``: such a prime whose L - 1 passes
      :data:`ONE_BLOCK_POINTS` and has a four-step split (Rader's
      convolution through device memory, :func:`rader_global_takes`);
    * ``"chirpz"``: N = :func:`chirp_size` of L (L has a prime factor above
      :data:`MIXED_MAX_PRIME`; the chirp-z transform, :func:`tile_plan` of N);
    * ``"split"``: such an N above :data:`ONE_BLOCK_POINTS` where L = P Q
      splits (:func:`split_plan`: P's transform by Rader or the chirp-z
      transform in one block a column, then the rows' mixed-radix FFTs of Q
      points, through device memory);
    * ``"cluster"``: such an N above :data:`ONE_BLOCK_POINTS` where L does
      not split and :func:`cluster_plan` has a plan (the whole chirp-z
      transform on chip, a frame a cluster of up to 8 blocks, one an SM);
    * ``"global"``: N above :data:`ONE_BLOCK_POINTS`, whatever the kind (the
      four-step FFT through device memory, :func:`four_step_plan` of N).

    Each of the last eight takes any hop.  Raises ``ValueError`` only for
    ``n_fft`` or ``hop`` below 1 (and past :func:`chirp_size`'s reach).
    The direct DFT is a route only comparisons force."""
    if n_fft < 1 or hop < 1:
        raise ValueError(f"spectrogram_power needs n_fft >= 1 and hop >= 1; got {n_fft}, {hop}")
    if n_fft in N_FFTS and hop % 4 == 0:
        return "fft"
    L, N = fft_shape(n_fft)
    if N != L and rader_launch_plan(L) is not None:
        return "rader"
    if N != L and rader_global_takes(L):
        return "rader_global"
    if N != L and N > ONE_BLOCK_POINTS and split_plan(L) is not None:
        return "split"
    if N != L and N > ONE_BLOCK_POINTS and cluster_plan(L, chirp_bins(n_fft)) is not None:
        return "cluster"
    if N > ONE_BLOCK_POINTS:
        return "global"
    if N != L:
        return "chirpz"
    return "mixed" if n_fft % 2 == 0 else "mixed_odd"


def _smem_bytes(n_fft: int, hop: int, frame_tile: int) -> int:
    """Shared memory of one block, as ``smem_bytes_for`` in the kernel's source:
    two sample slabs, one FFT exchange buffer per frame in flight, the
    (F, frame_tile) power tile."""
    M = n_fft // 2
    G = M // 8  # threads per frame
    frames_in_flight = THREADS // G
    slab = (frame_tile - 1) * hop + n_fft
    tile_stride = (frame_tile + 31) // 32 * 32 + (32 // G if G < 32 else 1)
    return 4 * 2 * slab + 8 * frames_in_flight * (M + 8) + 4 * (M + 1) * tile_stride


def launch_plan(n_fft: int, hop: int) -> LaunchPlan:
    """The kernel's frame tile and shared memory for this geometry.

    The tile is the largest power of two up to 32 frames (32 was the fastest
    at the main shape on an H100) whose block fits in :data:`SMEM_LIMIT`;
    one frame always fits.  Raises ``ValueError`` for a geometry the kernel
    does not take.
    """
    if n_fft not in N_FFTS:
        raise ValueError(f"the CUDA spectrogram kernel needs n_fft in {N_FFTS}; got {n_fft}")
    if hop < 4 or hop % 4:
        raise ValueError(f"the CUDA spectrogram kernel needs hop a positive multiple of 4; got {hop}")
    ft = 32
    while ft > 1 and _smem_bytes(n_fft, hop, ft) > SMEM_LIMIT:
        ft //= 2
    return LaunchPlan(ft, _smem_bytes(n_fft, hop, ft))


def kernel_tables(n_fft: int, window: str = "hann"):
    """The kernel's host tables, built in float64 and rounded to float32:
    the window (n_fft,), the periodic Hann window or ones for ``"rect"``,
    and the twiddles ``e^{-2 pi i k / n_fft}``, k < n_fft, as (n_fft, 2)
    (re, im) pairs."""
    ang = -2.0 * np.pi * np.arange(n_fft, dtype=np.float64) / n_fft
    twiddle = np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32)
    return analysis_window(window, n_fft), twiddle


def spectrogram_power(x: torch.Tensor, n_fft: int = 256, hop: int = 128,
                      center: bool = True, window: str = "hann") -> torch.Tensor:
    """``|STFT|^2`` of the last axis as ``(..., 1 + n_fft//2, T)`` float32.

    Centered framing pads ``n_fft // 2`` zeros on both sides (librosa's
    ``pad_mode="constant"``).  ``window`` is ``"hann"`` (periodic) or
    ``"rect"`` (no window: the kernel multiplies by ones, which is exact).
    Matches :func:`stft_power` to float32 rounding.
    """
    if x.device.type == "cpu":
        return stft_power(x, n_fft=n_fft, hop=hop, center=center, window=window)
    return _spectrogram_power_cuda(x, n_fft, hop, center, window, k1_route(n_fft, hop))


def chirpz_tables(n_fft: int, M: Optional[int] = None):
    """The chirp-z route's host tables for an n_fft, in float64 rounded to
    float32 (no sine on the card), as (re, im) pairs: the chirp c_j =
    e^{-i pi j^2 / L}, j < L, its angle from j^2 mod 2L in 64-bit integers;
    Bt = FFT_M(b) / M of the padded conjugate chirp b (b_m = conj(c_m) at m
    < K, the bins wanted (:func:`chirp_bins`), and at M - m, 0 < m < L, zero
    elsewhere); and the twiddles e^{-2 pi i j / M}, j < M; L the complex
    length, M = :func:`fft_shape`'s chirp-z size unless given."""
    L, K = (n_fft // 2 if n_fft % 2 == 0 else n_fft), chirp_bins(n_fft)
    M = chirp_size(L, K) if M is None else M
    if M < max(2, L + K - 1):
        raise ValueError(f"a chirp-z size of {M} wraps the lags of n_fft {n_fft}")
    return _chirp_tables_of(L, K, M)


def _chirp_tables_of(L: int, K: int, M: int):
    """The chirp-z tables of a complex length L, K bins, M points
    (:func:`chirpz_tables`)."""
    j = np.arange(L, dtype=np.int64)
    c = np.exp(-1j * np.pi * ((j * j) % (2 * L)).astype(np.float64) / L)
    b = np.zeros(M, np.complex128)
    b[:K] = np.conj(c[:K])
    b[M - j[1:]] = np.conj(c[1:])
    bt = np.fft.fft(b) / M
    ang = -2.0 * np.pi * np.arange(M, dtype=np.float64) / M
    return _pairs(c), _pairs(bt), _pairs(np.cos(ang) + 1j * np.sin(ang))


class SplitPlan(NamedTuple):
    P: int  # the prime factor above MIXED_MAX_PRIME: a column's points
    Q: int  # L / P: the columns of a frame, a row's points
    kind: str  # the column transform: "rader" (over P - 1 points) or "chirpz"
    M: int  # the column transform's points: P - 1, or chirp_size(P)
    col: LaunchPlan  # columns a block
    row: LaunchPlan  # rows a block


def split_column_plan(kind: str, M: int) -> Optional[LaunchPlan]:
    """The split route's column tile for an M-point column transform
    (``apt_spectrogram_power_split``, which takes any tile whose block
    fits): two tile buffers of M points, and for Rader each column's z_0
    and A_0 (16 bytes); the largest power of two up to
    :data:`MIXED_MAX_TILE` columns whose block fits an eighth of
    :data:`SMEM_LIMIT` (eight blocks an SM), but two where that is one and
    two fit a third (three blocks an SM), else one up to the whole limit;
    ``None`` where one column does not fit.  At 9,999/4,999 (M = 100) 16
    columns took 0.8674 ms against 0.9160 with 32; at 7,005/3,502 (M = 960)
    two 0.9954 against 1.1641 with one (H100 80GB HBM3, 700 W,
    ``tools/time_chirp_sizes.py --split``)."""
    extra = 16 if kind == "rader" else 0

    def smem(ft):
        return 16 * tile_elems(M, ft) + extra * ft

    ft = next((ft for ft in (32, 16, 8, 4, 2, 1) if smem(ft) <= SMEM_LIMIT // 8), 1)
    if ft == 1 and smem(2) <= SMEM_LIMIT // 3:
        ft = 2
    return LaunchPlan(ft, smem(ft)) if smem(ft) <= SMEM_LIMIT else None


def split_row_plan(Q: int) -> LaunchPlan:
    """The split route's row tile (``split_row_step`` of
    ``csrc/four_step.cuh``): :func:`tile_plan`'s rule with up to 256 rows
    of Q points a block in place of 32 (a block of 32 rows of few points has
    little work: at 14,530/7,265, Q = 5, the rows took 0.1286 ms a call with
    256 rows a block against 0.3362 with 32; H100 80GB HBM3, 700 W,
    ``tools/time_chirp_sizes.py --split``)."""
    for ft in (256, 128, 64):
        if 16 * tile_elems(Q, ft) <= SMEM_LIMIT // 4:
            return LaunchPlan(ft, 16 * tile_elems(Q, ft))
    return tile_plan(Q)


@functools.lru_cache(maxsize=None)
def split_plan(L: int) -> Optional[SplitPlan]:
    """The split route's plan for a complex length L (``split_of`` of
    ``csrc/four_step.cuh``): L = P Q with P its only prime factor above
    :data:`MIXED_MAX_PRIME`, dividing L once; Q >= 2 with a plan
    (:func:`mixed_radices`) of at most :data:`ONE_BLOCK_POINTS` points; P's
    transform in one block, by Rader's convolution over P - 1 points where
    P - 1 has a plan of at most :data:`ONE_BLOCK_POINTS` points, else by
    the chirp-z transform over :func:`chirp_size` of P points, where that
    is at most :data:`ONE_BLOCK_POINTS`.  ``None`` where L does not split
    so (two primes above 31, P squared, L prime, P too large)."""
    q, big = L, []
    for d in range(2, math.isqrt(L) + 1):
        while q % d == 0:
            big.append(d)
            q //= d
    big = [p for p in big + ([q] if q > 1 else []) if p > MIXED_MAX_PRIME]
    if len(big) != 1:
        return None
    P = big[0]
    Q = L // P
    if Q < 2 or Q > ONE_BLOCK_POINTS or mixed_radices(Q) is None:
        return None
    if P - 1 <= ONE_BLOCK_POINTS and mixed_radices(P - 1) is not None:
        kind, M = "rader", P - 1
    else:
        kind, M = "chirpz", chirp_size(P)
        if M > ONE_BLOCK_POINTS:
            return None
    col, row = split_column_plan(kind, M), split_row_plan(Q)
    if col is None or row is None:
        return None
    return SplitPlan(P, Q, kind, M, col, row)


@functools.lru_cache(maxsize=8)
def split_tables(n_fft: int):
    """The split route's host tables for its factor P (:func:`split_plan` of
    n_fft's complex length), float64 rounded to float32: for Rader ``(gin,
    bt, rtab)`` of :func:`rader_tables` for the prime P (gin int32); for the
    chirp-z transform ``(chirp, bt, ctab)`` of :func:`chirpz_tables` for a
    complex length P, all P bins, over the plan's M points."""
    plan = split_plan(n_fft // 2 if n_fft % 2 == 0 else n_fft)
    if plan.kind == "rader":
        (gin, _), (bt, rtab) = _rader_tables_of(plan.P)
        return gin, bt, rtab
    return _chirp_tables_of(plan.P, plan.P, plan.M)


def split_frame_points(n_fft: int) -> int:
    """Points a frame of the split route's chunk buffers: L, or for an odd
    n_fft (a real frame, whose rows past (P - 1) / 2 are their mirrors'
    conjugates) the (P + 1) / 2 rows of Q points it keeps."""
    L = n_fft // 2 if n_fft % 2 == 0 else n_fft
    plan = split_plan(L)
    return L if n_fft % 2 == 0 else (plan.P + 1) // 2 * plan.Q


def split_scratch_bytes(n_fft: int, frames: int) -> int:
    """Bytes of the split route's scratch: two chunk buffers of
    :func:`split_frame_points` a frame, :func:`chunk_frames` of them."""
    S = split_frame_points(n_fft)
    return 16 * S * chunk_frames(S, frames)


#: the routes :func:`_spectrogram_power_cuda` takes by name
K1_ROUTES = ("fft", "mixed", "mixed_odd", "rader", "rader_global", "chirpz", "split", "cluster",
             "global", "dft")


def _spectrogram_power_cuda(x: torch.Tensor, n_fft: int, hop: int, center: bool, window: str,
                            route: str, chirp_n: Optional[int] = None,
                            rader_half: Optional[bool] = None) -> torch.Tensor:
    """K1 on the card through ``route``: :func:`k1_route`'s for the
    geometry, or for comparisons another that takes it: ``"dft"`` (every
    n_fft up to :data:`DFT_MAX_N_FFT`), ``"chirpz"`` (every n_fft whose
    chirp-z size one block holds), ``"cluster"`` (every n_fft with a
    :func:`cluster_plan`), ``"global"`` (every n_fft whose
    :func:`fft_shape` size the four-step split takes) and ``"mixed"`` (every
    even size with a plan).  ``chirp_n`` forces the chirp-z size of the
    chirp-z and global routes (a 7-smooth size from L + K - 1 on, K =
    :func:`chirp_bins`); ``rader_half`` whether the global Rader route's
    first transform runs over (L - 1) / 2 points of packed pairs, as it
    does for an odd n_fft unless told otherwise (1.9122 ms against 2.4457
    over all L - 1 points at 65,537/32,768, 128 x 10 s, H100 80GB HBM3,
    700 W, ``chip_smoke.py`` phase 46; an even n_fft's frame is complex and
    takes all of them).  Raises where the route does not take the
    geometry."""
    analysis_window(window, 1)  # an unknown window raises here, before the launch
    if route not in K1_ROUTES:
        raise ValueError(f"spectrogram_power: no route {route!r}")
    if n_fft < 1 or hop < 1:
        raise ValueError(f"spectrogram_power needs n_fft >= 1 and hop >= 1; got {n_fft}, {hop}")
    L, N = fft_shape(n_fft)
    if chirp_n is not None and route in ("chirpz", "global"):
        N = chirp_n
    half = n_fft % 2 == 1 if rader_half is None else rader_half
    takes = {
        "fft": lambda: n_fft in N_FFTS and hop % 4 == 0,
        "mixed": lambda: mixed_route_takes(n_fft),
        "mixed_odd": lambda: n_fft % 2 == 1 and N == L <= ONE_BLOCK_POINTS,
        "rader": lambda: rader_launch_plan(L) is not None,
        "rader_global": lambda: rader_global_takes(L) and (not half or n_fft % 2 == 1),
        "chirpz": lambda: (N if chirp_n else chirp_size(L, chirp_bins(n_fft))) <= ONE_BLOCK_POINTS,
        "split": lambda: split_plan(L) is not None,
        "cluster": lambda: cluster_plan(L, chirp_bins(n_fft)) is not None,
        "global": lambda: four_step_plan(N) is not None,
        "dft": lambda: n_fft <= DFT_MAX_N_FFT,
    }[route]
    if not takes():
        raise ValueError(f"the {route} route does not take n_fft {n_fft}, hop {hop}")
    x = x.to(torch.float32).contiguous()
    lead = x.shape[:-1]
    n = x.shape[-1]
    xb = x.reshape(-1, n)
    _kernels.require_cuda("spectrogram_power", xb, torch.float32, 2)
    pad = n_fft // 2 if center else 0
    T = 1 + (n + 2 * pad - n_fft) // hop if n + 2 * pad >= n_fft else 0
    F = 1 + n_fft // 2
    out = torch.empty((xb.shape[0], F, T), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out.reshape(lead + (F, T))
    win, twiddle = device_constant(("spectrogram_tables", n_fft, window), x.device,
                                   lambda: kernel_tables(n_fft, window))
    chirp = bt = ctab = None
    if route in ("chirpz", "cluster") or (route == "global" and N != L):
        Mc = (cluster_plan(L, chirp_bins(n_fft)).M if route == "cluster"
              else chirp_n or chirp_size(L, chirp_bins(n_fft)))
        chirp, bt, ctab = device_constant(("chirpz_tables", n_fft, Mc), x.device,
                                          lambda: chirpz_tables(n_fft, Mc))
    lib = _kernels.build()
    args = (xb.data_ptr(), win.data_ptr(), twiddle.data_ptr())
    geo = (xb.shape[0], n, T, n_fft, hop, pad)
    stream = _kernels.stream_of(xb)
    with torch.cuda.device(x.device):
        if route == "dft":
            err = lib.lib.apt_spectrogram_power_dft(*args, out.data_ptr(), *geo, stream)
        elif route in ("rader", "rader_global"):
            rader = (*(device_constant(("rader_perms", n_fft), x.device,
                                       lambda: rader_tables(n_fft)[0], torch.int32)),
                     *device_constant(("rader_tables", n_fft), x.device,
                                      lambda: rader_tables(n_fft)[1]))
            rader = tuple(t.data_ptr() for t in rader)
            if route == "rader":
                plan = rader_launch_plan(L)
                err = lib.lib.apt_spectrogram_power_rader(
                    *args, *rader, out.data_ptr(), *geo, plan.frame_tile, plan.smem_bytes,
                    stream)
            else:
                rwin = device_constant(("rader_window", n_fft, window), x.device,
                                       lambda: rader_window(n_fft, window))
                nbytes = rader_global_scratch_bytes(L, xb.shape[0] * T)
                scratch = torch.empty(nbytes // 4, dtype=torch.float32, device=x.device)
                err = lib.lib.apt_spectrogram_power_rader_global(
                    *args, *rader, rwin.data_ptr(), out.data_ptr(), *geo, int(half),
                    scratch.data_ptr(), nbytes, stream)
        elif route == "split":
            sp = split_plan(L)
            tabs = device_constant(("split_tables", n_fft, sp.P), x.device,
                                   lambda: split_tables(n_fft)[1:])
            gin = chirp = None
            if sp.kind == "rader":
                gin = device_constant(("split_gin", n_fft, sp.P), x.device,
                                      lambda: split_tables(n_fft)[0], torch.int32)
            else:
                chirp = device_constant(("split_chirp", n_fft, sp.P), x.device,
                                        lambda: split_tables(n_fft)[0])
            nbytes = split_scratch_bytes(n_fft, xb.shape[0] * T)
            scratch = torch.empty(nbytes // 4, dtype=torch.float32, device=x.device)
            err = lib.lib.apt_spectrogram_power_split(
                *args, *(None if t is None else t.data_ptr() for t in (gin, chirp, *tabs)),
                out.data_ptr(), *geo, sp.M, sp.col.frame_tile, sp.col.smem_bytes,
                scratch.data_ptr(), nbytes, stream)
        elif route == "cluster":
            cp = cluster_plan(L, chirp_bins(n_fft))
            err = lib.lib.apt_spectrogram_power_cluster(
                *args, chirp.data_ptr(), bt.data_ptr(), ctab.data_ptr(), out.data_ptr(), *geo,
                cp.C, cp.M, cp.N1, cp.smem_bytes, stream)
        elif route == "chirpz":
            plan = chirpz_launch_plan(ctab.shape[0])
            err = lib.lib.apt_spectrogram_power_chirpz(
                *args, chirp.data_ptr(), bt.data_ptr(), ctab.data_ptr(), out.data_ptr(), *geo,
                ctab.shape[0], plan.frame_tile, plan.smem_bytes, stream)
        elif route == "global":
            frames = chunk_frames(N, xb.shape[0] * T)
            scratch = torch.empty(4 * N * frames, dtype=torch.float32, device=x.device)
            err = lib.lib.apt_spectrogram_power_global(
                *args, *(None if t is None else t.data_ptr() for t in (chirp, bt, ctab)),
                out.data_ptr(), *geo, N, scratch.data_ptr(), 4 * scratch.numel(), stream)
        else:
            launch, plan = {
                "fft": (lib.lib.apt_spectrogram_power, lambda: launch_plan(n_fft, hop)),
                "mixed": (lib.lib.apt_spectrogram_power_mixed, lambda: mixed_launch_plan(n_fft)),
                "mixed_odd": (lib.lib.apt_spectrogram_power_odd, lambda: tile_plan(n_fft)),
            }[route]
            plan = plan()
            err = launch(*args, out.data_ptr(), *geo, plan.frame_tile, plan.smem_bytes, stream)
    lib.check(err, "spectrogram_power")
    _kernels.count("spectrogram_power")
    return out.reshape(lead + (F, T))


def cluster_max_active(C: int, smem_bytes: int) -> int:
    """How many clusters of ``C`` blocks of ``smem_bytes`` shared memory each
    the current card holds at once (``cudaOccupancyMaxActiveClusters`` for
    the cluster route's kernel); 0 where the card cannot schedule one, which
    the route's launcher refuses before it launches."""
    import ctypes

    lib = _kernels.build()
    active = ctypes.c_int(0)
    lib.check(lib.lib.apt_cluster_max_active(C, smem_bytes, ctypes.byref(active)),
              "spectrogram_power")
    return active.value
