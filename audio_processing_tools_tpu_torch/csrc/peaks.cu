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
// puts NaN after every number).  Step k < min(max_peaks, n) takes the k-th
// position p of that order; if p is a peak still kept, it clears `keep` at
// every index in (p - d, p + d) but p.  The output is keep & is_peak.  The
// cap is part of the function: peaks past the 64th never clear others.
//
// What bounds it on this card: bytes, rows * n * 6 (x, is_peak in, the
// mask out): at the confirmer's (871, 384) 2.0 MB, 0.0006 ms at 3.35 TB/s.
// The work is a chain of up to 64 dependent block-wide reductions a row,
// so its latency, not the bound, sets the time.
//
// Design: one block of 128 threads per row, rows of at most 1,024 positions
// (8 a thread, in registers).  Each thread keeps its positions' sort keys
// and three bit masks (peak, keep, taken).  A step is one block-wide max of
// 64-bit keys (order key << 32 | index << 2 | peak << 1 | keep): warp
// shuffles, one slot per warp in shared memory (double-buffered by the
// step's parity, so one barrier a step suffices), then every thread reads
// the four slots and knows p, whether it is a kept peak, and clears its own
// positions in p's window.  Once the winner is -inf and the row has no
// peak of value -inf or NaN, the steps left would land on non-peaks, which
// change nothing, and the loop ends.  No arithmetic on values: the result
// is the JAX loop's bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 8;

// an unsigned key that grows with the value: -0 equal to +0, NaN below -inf,
// 0 left free for positions already taken
__device__ __forceinline__ uint32_t order_key(float v) {
  if (v != v) return 1u;
  if (v == 0.f) v = 0.f;
  const uint32_t u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__global__ void __launch_bounds__(kThreads)
select_peaks_by_distance_kernel(const float* __restrict__ x,
                                const uint8_t* __restrict__ is_peak,
                                uint8_t* __restrict__ out, int n, int distance,
                                int steps) {
  __shared__ unsigned long long s_best[2][kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t row = (size_t)blockIdx.x * n;
  const uint32_t neg_inf_key = order_key(-__int_as_float(0x7f800000));

  uint32_t vkey[kPerThread];
  unsigned peak = 0, keep = 0, taken = 0;
  bool nonfinite_peak = false;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int i = tid + j * kThreads;
    vkey[j] = 0u;
    if (i < n) {
      const bool pk = is_peak[row + i] != 0;
      const float v = x[row + i];
      vkey[j] = order_key(pk ? v : -__int_as_float(0x7f800000));
      peak |= (unsigned)pk << j;
      nonfinite_peak |= pk && !(v > -__int_as_float(0x7f800000));
    } else {
      taken |= 1u << j;  // past the row: never a candidate
    }
  }
  keep = peak;
  nonfinite_peak = __syncthreads_or(nonfinite_peak);

  for (int k = 0; k < steps; ++k) {
    unsigned long long best = 0ull;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      if (!((taken >> j) & 1u)) {
        const unsigned long long key =
            ((unsigned long long)vkey[j] << 32) |
            ((unsigned)(tid + j * kThreads) << 2) | (((peak >> j) & 1u) << 1) |
            ((keep >> j) & 1u);
        best = key > best ? key : best;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned long long o = __shfl_xor_sync(0xffffffffu, best, off);
      best = o > best ? o : best;
    }
    if (lane == 0) s_best[k & 1][warp] = best;
    __syncthreads();
    best = s_best[k & 1][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      const unsigned long long o = s_best[k & 1][w];
      best = o > best ? o : best;
    }
    if ((uint32_t)(best >> 32) <= neg_inf_key && !nonfinite_peak) break;
    const int p = (int)((uint32_t)best >> 2);
    if ((p & (kThreads - 1)) == tid) taken |= 1u << (p / kThreads);
    if ((best & 3ull) == 3ull) {  // a peak still kept
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        const int i = tid + j * kThreads;
        if (i > p - distance && i < p + distance && i != p) keep &= ~(1u << j);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int i = tid + j * kThreads;
    if (i < n) out[row + i] = (uint8_t)((peak & keep) >> j & 1u);
  }
}

}  // namespace

extern "C" int apt_select_peaks_by_distance(const float* x, const uint8_t* is_peak,
                                            uint8_t* out, int rows, int n,
                                            int distance, int steps,
                                            void* stream) {
  if (rows <= 0 || n <= 0 || n > kThreads * kPerThread || steps < 0 || steps > n)
    return (int)cudaErrorInvalidValue;
  select_peaks_by_distance_kernel<<<rows, kThreads, 0, (cudaStream_t)stream>>>(
      x, is_peak, out, n, distance, steps);
  return (int)cudaGetLastError();
}
