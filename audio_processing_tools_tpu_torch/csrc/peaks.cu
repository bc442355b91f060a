// K9: scipy's distance filter over peaks, as the JAX package bounds it,
// hand-written for Hopper (sm_90a).
//
// Replaces the `lax.fori_loop` of `select_peaks_by_distance`
// (audio_processing_tools_tpu/ops/peaks.py:185-208), which the stage-2
// time-domain confirmer runs under `vmap` over its analysis windows
// (models/time_domain.py:144).  It was not a Pallas kernel: XLA compiled
// the loop into one program.  As eager PyTorch each of its 64 steps
// launches about eight small kernels over all rows.
//
// What it computes, per row of n positions: the order is tallest first,
// ties to the larger index, where a non-peak counts as -inf (JAX's
// `lexsort((-arange(n), -vals))`; its sort key holds -0 equal to +0 and
// puts NaN after every number).  Step k < steps = min(max_peaks, n) takes
// the k-th position p of that order; if p is a peak still kept, it clears
// `keep` at every index in (p - d, p + d) but p.  The output is
// keep & is_peak.  The cap is part of the function: peaks past it never
// clear others.
//
// What bounds it on this card: bytes, rows * n * 6 (x, is_peak in, the
// mask out): at the confirmer's (871, 384) 2.0 MB, 0.0006 ms at 3.35 TB/s.
// The loop itself is a chain of dependent steps a row, so latency, not the
// bound, sets the time; the design keeps that chain short.
//
// Design: one warp a row, kWarps rows a block, no block barrier.
//
//  1. Loads.  Lane l holds positions 128 c + 4 l + j (j < 4) of a row of at
//     most 1,024, a word of 4 bits of is_peak a group; all loads are in
//     flight before the first is used.  (16-byte loads where a row is
//     aligned measured no faster: tools/time_k9.py --variant vector-loads.)
//  2. The peaks' keys, in position order.  Three ballots give each lane's
//     exclusive count of peaks, so slot s of the warp's list in shared
//     memory holds the peak with s peaks before it in the row, under the
//     64-bit key order_key(value) << 32 | s << 16 | index.  The slot grows
//     with the index, so all keys are distinct and descending key order is
//     the JAX order.
//  3. The candidates in order, found once.  Non-peaks take steps but change
//     nothing, so the candidates are the peaks ranked below `steps` among
//     all positions: a prefix of the peaks' order.  A peak's rank among all
//     positions is its rank among the peaks plus the non-peaks ahead of it:
//     none for a value above -inf, (n - 1 - index) - (P - 1 - s) for -inf
//     (they tie with it and rank by index) and n - P for NaN.
//     a. Where the row has more peaks than `steps` and than one pass of
//        ranks (64), only its top `steps` keys can be candidates: the
//        steps-th key is found a bit at a time from the top, 42 rounds of a
//        count over the keys and a warp sum, and the keys at or above it
//        are kept in place.
//     b. Rank counting: a key's rank is the number of keys above it, each
//        lane counting for two slots at a time against all the keys in
//        shared memory, eight loads in flight; a candidate is written to the
//        list at its rank.
//  4. The walk over a bitmap of covered positions, one 32-bit word a lane.
//     A candidate p is a kept peak exactly when its bit is not covered yet;
//     then every lane ORs into its word the bits of (p - d, p + d) but p.
//     The chain of a step is one shuffle of p's word, a test and an OR; the
//     next candidates and their windows' bits are computed beside it.  A
//     kept candidate is never in another's window (windows are symmetric),
//     and a peak past the cap is cleared only by a kept candidate, so the
//     output is is_peak & ~covered.
//  5. Stores of the mask, a byte a position.
//
// Rows longer than 1,024 positions take a second kernel, one block a row
// (select_peaks_long): every position's key order_key(value) << 32 | index
// (a non-peak's value -inf, as in the JAX order) sorted in descending order
// by a bitonic network, in shared memory up to kLongSmemKeys keys and in
// device scratch beyond; the first `steps` keys are the loop's order, each
// marked with its peak bit by a parallel pass; then one warp walks them
// over a bitmap of covered positions (a word for 32 positions, in shared
// memory up to kLongSmemWords words), a step a candidate: the test of p's
// bit, and where p is a kept peak the lanes OR the words of its window.
//
// No arithmetic on values: the result is the JAX loop's bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLength = 1024;       // positions a row; ops/peaks.py::K9_MAX_LENGTH
constexpr int kWarps = 4;              // rows a block, one warp each
constexpr int kGroups = kMaxLength / 128;  // groups of 4 positions a lane
constexpr int kRankSlots = 2;          // slots a lane ranks in one pass over the keys
constexpr int kBatch = 8;              // keys loaded together in a pass
constexpr unsigned kFull = 0xffffffffu;

// an unsigned key that grows with the value: -0 equal to +0, NaN below -inf
__device__ __forceinline__ uint32_t order_key(float v) {
  if (v != v) return 1u;
  if (v == 0.f) v = 0.f;
  const uint32_t u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// the peak's key: order_key(value) << 32 | slot << 16 | index, where the
// slot (its rank in position order among the row's peaks) grows with the
// index, so descending keys are the JAX order
__device__ __forceinline__ unsigned long long make_key(float v, int slot, int index) {
  return ((unsigned long long)order_key(v) << 32) | ((unsigned)slot << 16) | (unsigned)index;
}

// lane's word of the bits of (p - d, p + d) but p
__device__ __forceinline__ unsigned window_bits(int p, int d, int lane) {
  const int lo = max(p - d + 1 - 32 * lane, 0), hi = min(p + d - 1 - 32 * lane, 31);
  unsigned win = lo <= hi ? (kFull >> (31 - hi)) & (kFull << lo) : 0u;
  if ((p >> 5) == lane) win &= ~(1u << (p & 31));
  return win;
}

__global__ void __launch_bounds__(kWarps * 32)
select_peaks_by_distance_kernel(const float* __restrict__ x,
                                const uint8_t* __restrict__ is_peak,
                                uint8_t* __restrict__ out, int rows, int n, int distance,
                                int steps) {
  extern __shared__ unsigned long long smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= rows) return;  // whole warps: nothing below waits on the block
  unsigned long long* keys = smem + (size_t)warp * n;
  uint16_t* cand = reinterpret_cast<uint16_t*>(smem + (size_t)kWarps * n) + (size_t)warp * n;
  const float* xr = x + (size_t)row * n;
  const uint8_t* pr = is_peak + (size_t)row * n;
  uint8_t* orow = out + (size_t)row * n;
  const int groups = (n + 127) >> 7;
  const unsigned lt = (1u << lane) - 1u;

  // 1. loads
  float v[kGroups][4];
  unsigned nib[kGroups];  // bit j: position 128 c + 4 lane + j is a peak
#pragma unroll
  for (int c = 0; c < kGroups; ++c) {
    const int q = 128 * c + 4 * lane;
    nib[c] = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[c][j] = 0.f;
      if (c < groups && q + j < n) {
        v[c][j] = xr[q + j];
        nib[c] |= (pr[q + j] != 0 ? 1u : 0u) << j;
      }
    }
  }

  // 2. the peaks' keys in position order
  int P = 0;
#pragma unroll
  for (int c = 0; c < kGroups; ++c) {
    if (c < groups) {
      const unsigned cnt = __popc(nib[c]);
      const unsigned b0 = __ballot_sync(kFull, cnt & 1u), b1 = __ballot_sync(kFull, cnt & 2u),
                     b2 = __ballot_sync(kFull, cnt & 4u);
      int slot = P + __popc(b0 & lt) + 2 * __popc(b1 & lt) + 4 * __popc(b2 & lt);
      P += __popc(b0) + 2 * __popc(b1) + 4 * __popc(b2);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if ((nib[c] >> j) & 1u) {
          keys[slot] = make_key(v[c][j], slot, 128 * c + 4 * lane + j);
          ++slot;
        }
      }
    }
  }
  __syncwarp();

  // 3a. more peaks than steps and than one pass of ranks: keep the top
  // `steps` keys only, in place.  The steps-th key is found a bit at a
  // time from the top; the slot's bits make every key distinct, so bits
  // 26-31 (zero) and 0-15 (the index, which the slot orders) are skipped.
  int ranked = P;
  if (steps < P && P > 32 * kRankSlots) {
    unsigned long long prefix = 0ull;
    unsigned left = (unsigned)steps;
    for (int b = 63; b >= 16; --b) {
      if (b == 31) b = 25;
      const unsigned long long want = prefix | (1ull << b), top = ~0ull << b;
      unsigned cnt = 0u;
      for (int s0 = 0; s0 < P; s0 += 32 * kBatch) {
        unsigned long long k[kBatch];
#pragma unroll
        for (int t = 0; t < kBatch; ++t) {
          const int s = s0 + 32 * t + lane;
          k[t] = s < P ? keys[s] : 0ull;  // 0: below every key's bit b
        }
#pragma unroll
        for (int t = 0; t < kBatch; ++t) cnt += (k[t] & top) == want ? 1u : 0u;
      }
      cnt = __reduce_add_sync(kFull, cnt);
      if (cnt >= left) {
        prefix = want;
      } else {
        left -= cnt;
      }
    }
    int kept = 0;
    for (int s0 = 0; s0 < P; s0 += 32) {
      const int s = s0 + lane;
      const unsigned long long key = s < P ? keys[s] : 0ull;
      const bool in_top = s < P && key >= prefix;
      const unsigned b = __ballot_sync(kFull, in_top);
      __syncwarp();
      if (in_top) keys[kept + __popc(b & lt)] = key;
      kept += __popc(b);
      __syncwarp();
    }
    ranked = kept;  // == steps
  }

  // 3b. the candidates in order: rank counting
  const uint32_t neg_inf_key = order_key(-__int_as_float(0x7f800000));
  int candidates = 0;
  for (int s0 = 0; s0 < ranked; s0 += 32 * kRankSlots) {
    unsigned long long mine[kRankSlots];
    int above[kRankSlots];
#pragma unroll
    for (int g = 0; g < kRankSlots; ++g) {
      const int s = s0 + 32 * g + lane;
      mine[g] = s < ranked ? keys[s] : ~0ull;
      above[g] = 0;
    }
    for (int i0 = 0; i0 < ranked; i0 += kBatch) {
      unsigned long long k[kBatch];
#pragma unroll
      for (int t = 0; t < kBatch; ++t) k[t] = i0 + t < ranked ? keys[i0 + t] : 0ull;  // 0: below
#pragma unroll
      for (int t = 0; t < kBatch; ++t) {
#pragma unroll
        for (int g = 0; g < kRankSlots; ++g) above[g] += k[t] > mine[g] ? 1 : 0;
      }
    }
#pragma unroll
    for (int g = 0; g < kRankSlots; ++g) {
      if (s0 + 32 * g + lane < ranked) {
        const uint32_t hi = (uint32_t)(mine[g] >> 32);
        const int slot = (int)(mine[g] >> 16) & 1023, pos = (int)mine[g] & 1023;
        // the non-peaks ahead of it in the order
        const int nonpeaks = hi > neg_inf_key    ? 0
                             : hi == neg_inf_key ? (n - 1 - pos) - (P - 1 - slot)
                                                 : n - P;
        if (above[g] + nonpeaks < steps) {
          cand[above[g]] = (uint16_t)pos;
          ++candidates;
        }
      }
    }
  }
  candidates = __reduce_add_sync(kFull, candidates);
  __syncwarp();

  // 4. the walk; lane w holds the covered bits of positions 32 w .. 32 w + 31
  const int d = distance < 0 ? 0 : distance > n ? n : distance;
  unsigned covered = 0u;
#pragma unroll 4
  for (int k = 0; k < candidates; ++k) {
    const int p = cand[k];
    const unsigned win = window_bits(p, d, lane);
    if (!((__shfl_sync(kFull, covered, p >> 5) >> (p & 31)) & 1u)) covered |= win;
  }

  // 5. stores: is_peak & ~covered
#pragma unroll
  for (int c = 0; c < kGroups; ++c) {
    if (c < groups) {
      const unsigned cw = __shfl_sync(kFull, covered, 4 * c + (lane >> 3));
      const unsigned keep = nib[c] & ~(cw >> (4 * (lane & 7))) & 0xfu;
      const int q = 128 * c + 4 * lane;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (q + j < n) orow[q + j] = (uint8_t)((keep >> j) & 1u);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Rows longer than kMaxLength: one block a row
// ---------------------------------------------------------------------------

constexpr int kLongThreads = 256;
constexpr int kLongSmemKeys = 16384;   // keys sorted in shared memory (128 KB), a power of two
constexpr int kLongSmemWords = 16384;  // bitmap words in shared memory (64 KB)

// mirrored by ops/peaks.py::k9_long_plan
struct LongPlan {
  int np2;  // keys sorted: n rounded up to a power of two
  bool keys_shared, bits_shared;
  size_t smem;
};

LongPlan long_plan(int n) {
  LongPlan p;
  p.np2 = 1;
  while (p.np2 < n) p.np2 *= 2;
  const int words = (n + 31) / 32;
  p.keys_shared = p.np2 <= kLongSmemKeys;
  p.bits_shared = words <= kLongSmemWords;
  p.smem = (p.keys_shared ? 8 * (size_t)p.np2 : 0) + (p.bits_shared ? 4 * (size_t)words : 0);
  return p;
}

__global__ void __launch_bounds__(kLongThreads)
select_peaks_long(const float* __restrict__ x, const uint8_t* __restrict__ is_peak,
                  uint8_t* __restrict__ out, int n, int np2, int keys_shared, int bits_shared,
                  int distance, int steps, unsigned long long* key_scratch,
                  unsigned* bit_scratch) {
  extern __shared__ unsigned long long smem[];
  const int row = blockIdx.x, tid = threadIdx.x;
  const int words = (n + 31) / 32;
  unsigned long long* const keys = keys_shared ? smem : key_scratch + (size_t)row * np2;
  unsigned* const covered = bits_shared
                                ? reinterpret_cast<unsigned*>(keys_shared ? smem + np2 : smem)
                                : bit_scratch + (size_t)row * words;
  const float* const xr = x + (size_t)row * n;
  const uint8_t* const pr = is_peak + (size_t)row * n;
  uint8_t* const orow = out + (size_t)row * n;
  const float neg_inf = -__int_as_float(0x7f800000);

  // every position's key, zero past the row (below every key)
  for (int i = tid; i < np2; i += kLongThreads) {
    unsigned long long key = 0ull;
    if (i < n) key = ((unsigned long long)order_key(pr[i] ? xr[i] : neg_inf) << 32) | (unsigned)i;
    keys[i] = key;
  }
  for (int w = tid; w < words; w += kLongThreads) covered[w] = 0u;
  __syncthreads();

  // bitonic sort, descending
  for (int k = 2; k <= np2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int q = tid; q < np2 / 2; q += kLongThreads) {
        const int i = 2 * j * (q / j) + (q % j), l = i + j;
        const unsigned long long a = keys[i], b = keys[l];
        const bool desc = (i & k) == 0;
        if (desc ? a < b : a > b) {
          keys[i] = b;
          keys[l] = a;
        }
      }
      __syncthreads();
    }
  }

  // the candidates: the first `steps` positions of the order, each with its
  // peak bit (bit 31 of the low word)
  for (int k = tid; k < steps; k += kLongThreads) {
    const unsigned p = (unsigned)keys[k];
    keys[k] = (unsigned long long)(p | (pr[p] ? 0x80000000u : 0u));
  }
  __syncthreads();

  // the walk: warp 0, a step a candidate
  if (tid < 32) {
    const int lane = tid;
    const int d = distance < 0 ? 0 : distance > n ? n : distance;
    for (int k0 = 0; k0 < steps; k0 += 32) {
      const unsigned mine = k0 + lane < steps ? (unsigned)keys[k0 + lane] : 0u;
      const int m = min(32, steps - k0);
      for (int j = 0; j < m; ++j) {
        const unsigned c = __shfl_sync(kFull, mine, j);
        if (!(c & 0x80000000u)) continue;  // a non-peak: the step changes nothing
        const int p = (int)(c & 0x7fffffffu);
        if ((covered[p >> 5] >> (p & 31)) & 1u) continue;  // cleared already
        const int lo = max(p - d + 1, 0), hi = min(p + d - 1, n - 1);
        if (lo <= hi) {
          for (int w = (lo >> 5) + lane; w <= (hi >> 5); w += 32) {
            const int a = max(lo - 32 * w, 0), b = min(hi - 32 * w, 31);
            unsigned win = (kFull >> (31 - b)) & (kFull << a);
            if ((p >> 5) == w) win &= ~(1u << (p & 31));
            covered[w] |= win;
          }
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();

  // stores: is_peak & ~covered
  for (int i = tid; i < n; i += kLongThreads)
    orow[i] = (uint8_t)(pr[i] != 0 && !((covered[i >> 5] >> (i & 31)) & 1u));
}

}  // namespace

// Rows of more than 1,024 positions: key_scratch rows * np2 keys where the
// keys do not fit shared memory, bit_scratch rows * ceil(n / 32) words
// where the bitmap does not (ops/peaks.py::k9_long_plan), else null.
extern "C" int apt_select_peaks_long(const float* x, const uint8_t* is_peak, uint8_t* out,
                                     int rows, int n, int distance, int steps,
                                     unsigned long long* key_scratch, unsigned* bit_scratch,
                                     void* stream) {
  if (rows <= 0 || n <= kMaxLength || steps < 0 || steps > n) return (int)cudaErrorInvalidValue;
  const LongPlan p = long_plan(n);
  if ((!p.keys_shared && key_scratch == nullptr) || (!p.bits_shared && bit_scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  static int dev_set = -1;
  static size_t smem_set = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev != dev_set || p.smem > smem_set) {
    err = cudaFuncSetAttribute(select_peaks_long, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)p.smem);
    if (err != cudaSuccess) return (int)err;
    dev_set = dev;
    smem_set = p.smem;
  }
  select_peaks_long<<<rows, kLongThreads, p.smem, (cudaStream_t)stream>>>(
      x, is_peak, out, n, p.np2, p.keys_shared, p.bits_shared, distance, steps, key_scratch,
      bit_scratch);
  return (int)cudaGetLastError();
}

extern "C" int apt_select_peaks_by_distance(const float* x, const uint8_t* is_peak,
                                            uint8_t* out, int rows, int n,
                                            int distance, int steps,
                                            void* stream) {
  if (rows <= 0 || n <= 0 || n > kMaxLength || steps < 0 || steps > n)
    return (int)cudaErrorInvalidValue;
  // a warp's keys (8 bytes a position) and candidates (2 bytes a position)
  const size_t smem = (size_t)kWarps * n * 10;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        select_peaks_by_distance_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (rows + kWarps - 1) / kWarps;
  select_peaks_by_distance_kernel<<<blocks, kWarps * 32, smem, (cudaStream_t)stream>>>(
      x, is_peak, out, rows, n, distance, steps);
  return (int)cudaGetLastError();
}
