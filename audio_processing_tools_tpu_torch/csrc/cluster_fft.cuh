// The M-point FFT of K1's cluster route (spectrogram_cluster.cu), held on
// chip by a thread-block cluster of C blocks, one an SM: the four-step
// split M = N1 N2 (four_step.cuh states it) with C | N1 and C | N2, each
// block holding M / C points in two shared buffers, the blocks reading each
// other's buffers through distributed shared memory (the cluster's
// map_shared_rank) where the split's transpose crosses them.
//
// Block r holds either N2 / C columns of N1 points (columns n2 = r nc + j,
// nc = N2 / C: point n1 of column j at buf[n1 ldc + j], ldc = nc made odd)
// or N1 / C rows of N2 points (rows k1 = r nr + i, nr = N1 / C: point n2 of
// row i at buf[i ldr + n2], ldr = N2 made odd).  A transform of every line
// (column or row) of a block is mixed_fft.cuh's lines_fft, the Stockham
// transform over a layout of two strides, point m of line f at buf[m ps +
// f fs]: (ps, fs) = (ldc, 1) for columns, (1, ldr) for rows, its twiddles
// from the block's tables in shared memory.  A pass's work item is (line f,
// butterfly b), f fastest, so the lanes of a warp take the same butterfly
// of consecutive lines, at addresses fs apart: 1, or the odd ldr, both free
// of bank conflicts; the line count need not be a power of two.  With C = 1
// the block holds all N2 columns at ldc = ldr, so the column layout read as
// rows is the row layout and no exchange is needed.
//
// The exchange gathers a block's lines from every block of the cluster
// between two cluster barriers (every block's lines are written before the
// first; none is overwritten before every block has read it, the second):
// the reads run along a remote line, the writes along a local one.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "four_step.cuh"
#include "mixed_fft.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kClusterThreads = 512;  // threads of a block: one block an SM
constexpr int kMaxCluster = 8;        // blocks of a cluster: the portable maximum

// x / d by a multiply and a shift (m = ceil(2^32 / d), exact while x d <
// 2^32): the index arithmetic of the cluster route divides by the split's
// sizes, which a launch fixes, and a GPU has no integer divider.
struct Div {
  unsigned long long m;
  __host__ static Div of(int d) { return {((1ULL << 32) + (unsigned)d - 1) / (unsigned)d}; }
  __device__ __forceinline__ int operator()(int x) const {
    return (int)(((unsigned long long)(unsigned)x * m) >> 32);
  }
};

// The split of an M-point transform over a cluster of C blocks (mirrored by
// ops/spectrogram.py::cluster_split): among N1 N2 = M with C | N1, C | N2 and
// N1 <= N2, the fewest passes of the two transforms together, then the
// largest N1; two buffers of `elems` float2 a block, then the block's
// twiddle tables, `tw` float2 (ClusterTables).
struct ClusterSplit {
  int C, M, N1, N2, nc, nr, ldc, ldr, elems;
  int sh, tw;  // the four-step twiddle's split x = (x >> sh) 2^sh + low bits
  Div by_nc, by_nr, by_N2;
  bool ok;
};

// Bytes of a block's shared memory: the two buffers and the tables.
__host__ __device__ inline long long cluster_smem(const ClusterSplit& s) {
  return 16LL * s.elems + 8LL * s.tw;
}

__host__ inline ClusterSplit cluster_split_of(int M, int C) {
  ClusterSplit s{C, M, 0, 0, 0, 0, 0, 0, 0, 0, 0, {}, {}, {}, false};
  if (C < 1 || C > kMaxCluster || (C & (C - 1)) != 0 || M < 4) return s;
  int best = 1 << 30;
  for (int d = C; (long long)d * d <= M; d += C) {
    if (M % d != 0 || (M / d) % C != 0) continue;
    const int p1 = mixed_plan_of(d).n_pass, p2 = mixed_plan_of(M / d).n_pass;
    if (p1 == 0 || p2 == 0) continue;
    if (p1 + p2 <= best) {
      best = p1 + p2;
      s.N1 = d;
    }
  }
  if (s.N1 == 0) return s;
  s.N2 = M / s.N1;
  s.nc = s.N2 / C;
  s.nr = s.N1 / C;
  s.ldc = s.nc | 1;
  s.ldr = s.N2 | 1;
  const long long a = (long long)s.N1 * s.ldc, b = (long long)s.nr * s.ldr;
  const long long e = a > b ? a : b;
  s.elems = (int)(e + (e & 1));
  while ((1LL << (2 * s.sh)) < M) ++s.sh;  // 2^sh >= sqrt(M)
  s.tw = s.N1 + s.N2 + (1 << s.sh) + ((M - 1) >> s.sh) + 1;
  s.by_nc = Div::of(s.nc);
  s.by_nr = Div::of(s.nr);
  s.by_N2 = Div::of(s.N2);
  // every quotient the kernel takes (of an index below M by at most N2) is exact
  s.ok = cluster_smem(s) <= kBlockSmemLimit && (long long)M * s.N2 < (1LL << 32);
  return s;
}

// A block's twiddle tables in shared memory, copied at its start from the
// host's table of M (e^{-2 pi i j / M}, float64 rounded to float32): the
// column and row transforms' own (e^{-2 pi i j / N1}, e^{-2 pi i j / N2}),
// whose reads the lanes of a warp share; and the four-step twiddle's two
// factors, e^{-2 pi i x / M} = hi[x >> sh] lo[x & (2^sh - 1)], 2^sh + M / 2^sh
// entries about 2 sqrt(M) in place of M, which the lanes read at scattered
// indices: from shared memory, not as 32 sectors of L2 a warp.
struct ClusterTables {
  float2 *t1, *t2, *lo, *hi;
  int sh;
  __device__ __forceinline__ float2 four_step(int x) const {
    return cmul(hi[x >> sh], lo[x & ((1 << sh) - 1)]);
  }
};

// The tables at `at` (s.tw float2), copied from ctab by the block's threads;
// the block synchronises before it reads them.
__device__ __forceinline__ ClusterTables load_tables(float2* at, const ClusterSplit& s,
                                                     const float2* __restrict__ ctab) {
  const ClusterTables t{at, at + s.N1, at + s.N1 + s.N2, at + s.N1 + s.N2 + (1 << s.sh), s.sh};
  const int n1 = s.N1, n12 = n1 + s.N2, nlo = n12 + (1 << s.sh);
  for (int j = threadIdx.x; j < s.tw; j += blockDim.x) {
    const int i = j < n1 ? j * s.N2 : j < n12 ? (j - n1) * n1 : j < nlo ? j - n12 : (j - nlo) << s.sh;
    at[j] = __ldg(ctab + i);
  }
  return t;
}

// The last pass's store, by mode: output k of the block's line f, which is
// line g = base + f of the transform:
//   kStore    as it is;
//   kTwiddle  times e^{-2 pi i k g / M} (the four-step twiddle, `tabs`);
//   kConjBt   conj(v Bt[g + kstride k]) (bt: Bt, g + kstride k the bin);
//   kPower    |v|^2 to out[m T] for bin m = g + kstride k < F, nothing stored.
struct LastOut {
  enum Mode { kStore = 0, kTwiddle = 1, kConjBt = 2, kPower = 3 };
  int mode, base, kstride;
  ClusterTables tabs;
  const float2* bt;
  float* out;
  int F;
  long long T;
  __device__ __forceinline__ void operator()(float2* dst, int k, int f, const Lines& ln,
                                             float2 v) const {
    const int g = base + f;
    if (mode == kPower) {
      const int m = g + kstride * k;
      if (m < F) out[m * T] = v.x * v.x + v.y * v.y;
      return;
    }
    if (mode == kTwiddle) {
      if (k > 0 && g > 0) v = cmul(v, tabs.four_step(k * g));
    } else if (mode == kConjBt) {
      v = cmul(v, __ldg(bt + g + kstride * k));
      v.y = -v.y;
    }
    dst[ln.at(k, f)] = v;
  }
};

// to(e, from(e)) for e < n, over the block's threads, kInFlight values a
// thread read before any is stored: the reads (device memory, L2, another
// block's shared memory) overlap their latencies, where a loop of reads and
// stores, which the compiler cannot reorder past a store that may alias,
// would wait for each.
constexpr int kInFlight = 8;

template <class From, class To>
__device__ __forceinline__ void copy_in_flight(int n, const From& from, const To& to) {
  using V = decltype(from(0));
  for (int e0 = threadIdx.x; e0 < n; e0 += kInFlight * blockDim.x) {
    V v[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int e = e0 + u * (int)blockDim.x;
      if (e < n) v[u] = from(e);
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int e = e0 + u * (int)blockDim.x;
      if (e < n) to(e, v[u]);
    }
  }
}

// The exchange from columns to rows: block r's rows k1 = r nr + i, point n2
// from column n2 mod nc of block n2 / nc (`cols`, the same offset in every
// block's shared memory), into `rows`.
__device__ __forceinline__ void gather_rows(const float2* cols, float2* rows, const ClusterSplit& s,
                                            int r) {
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();
  copy_in_flight(
      s.nr * s.N2,
      [&](int e) {
        const int i = s.by_N2(e), n2 = e - i * s.N2;
        const int src = s.by_nc(n2), j = n2 - src * s.nc;
        return cl.map_shared_rank(cols, src)[(r * s.nr + i) * s.ldc + j];
      },
      [&](int e, float2 v) {
        const int i = s.by_N2(e);
        rows[i * s.ldr + e - i * s.N2] = v;
      });
  cl.sync();
}

// The exchange from rows to columns: block r's columns m2 = r nc + j, point
// k1 from row k1 mod nr of block k1 / nr (`rows`), into `cols`.
__device__ __forceinline__ void gather_columns(const float2* rows, float2* cols,
                                               const ClusterSplit& s, int r) {
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();
  copy_in_flight(
      s.N1 * s.nc,
      [&](int e) {
        const int k1 = s.by_nc(e), j = e - k1 * s.nc;
        const int src = s.by_nr(k1), i = k1 - src * s.nr;
        return cl.map_shared_rank(rows, src)[i * s.ldr + r * s.nc + j];
      },
      [&](int e, float2 v) {
        const int k1 = s.by_nc(e);
        cols[k1 * s.ldc + e - k1 * s.nc] = v;
      });
  cl.sync();
}

}  // namespace
