// K11-K13: the shape of peaks along a row (local maxima, prominences and
// widths), as the JAX package computes them, hand-written for Hopper
// (sm_90a).
//
// Replaces three stages of audio_processing_tools_tpu/ops/peaks.py that XLA
// compiles into one fused program each and eager PyTorch runs as many
// passes over materialised planes: `local_maxima` (:27-71, two
// `lax.cummax` scans), `peak_prominences` (:74-105) and `peak_widths_rel`
// (:108-163), both O(n^2) masked planes.  None was a Pallas kernel.
//
// K11, local_maxima.  A position m is marked where its plateau [s, e] (the
// run of equal samples around it; NaN equals nothing) is entered by a rise,
// left by a fall, and m = (s + e) / 2.  Every such plateau ends at a fall
// boundary e (between samples e and e + 1, x[e + 1] < x[e]), and its start
// is one past the last change boundary before e.  So one scan from the left
// suffices: boundary j is encoded as the JAX function encodes it, j * 2 + up
// where x[j + 1] != x[j], else -1, and the exclusive running max of the
// codes at a fall boundary j gives the plateau's entering change; where
// that change was a rise, the midpoint of [(code >> 1) + 1, j] is marked.
// The comparisons are the JAX function's (`!=` true at a NaN, `<` and `>`
// false) and the rest is integer work, so the mask is exact.  Design: one
// warp a row, chunks of 128 positions (4 a lane), a warp max-scan of the
// lanes' codes carried across chunks.  A chunk's positions are zeroed
// before its marks, which land in the chunk or in an earlier one.
//
// K12, peak_prominences.  For a peak p, each side extends from p to the
// first strictly higher sample (a NaN never stops it) or the border; the
// side's base is its minimum, p included, with NaN propagating as
// `torch.amin` and `jnp.min` do; the prominence is x[p] - max(bases), NaN
// propagating as `torch.maximum` does, and +0.0 off the peaks.  Design: one
// warp a row; the peaks are queued 32 at a time (a ballot a chunk of 32
// positions, ranks by popcount), and a lane walks one peak's two sides:
// O(n) a peak, no plane.  Rows up to kSharedMax positions are staged in
// shared memory; longer ones are read from device memory.  Where the
// minimum ties -0.0 with +0.0 the kernel keeps the one nearer p: the
// plain version's choice depends on its reduction order, so such a zero
// can differ in sign only (x[p] = -0.0 against a base of +0.0).
//
// K13, peak_widths_rel.  For a peak p, h = x[p] - rel_height * prom[p]
// (the product rounded, then the difference), the last sample at or below
// h left of p and the first right of p, each crossing interpolated
// linearly, width = right - left; the JAX function's operations one by one
// (`_rn` intrinsics: no contraction into an FMA, IEEE division), a picked
// sample + 0.0 as the plain version's one-hot sum makes it.  The same
// queue of peaks and a lane a peak as K12.
//
// What bounds them on this card: bytes.  K11 reads 4 bytes a position and
// writes 1; K12 reads 5 and writes 4; K13 reads 9 and writes 4 (x, the
// mask, the prominences).  The walks are chains of dependent loads, so at
// the path's short rows latency, not the bound, sets the time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;            // rows a block, one warp each
constexpr int kPer = 4;              // K11: positions a lane takes in a chunk
constexpr int kChunk = 32 * kPer;    // K11: positions a warp takes in a chunk
constexpr int kSharedMax = 2048;     // K12/K13: rows staged in shared memory; ops/peaks.py::PEAK_SHAPE_SHARED_MAX
constexpr int kQueue = 64;           // K12/K13: a warp's queue of peak positions
constexpr unsigned kFull = 0xffffffffu;

// K11 on rows of n < 2^30 positions with int codes, longer ones with 64-bit
template <typename I>
__global__ void __launch_bounds__(kWarps * 32)
local_maxima_kernel(const float* __restrict__ x, uint8_t* __restrict__ out, long long rows, I n) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps: nothing below waits on the block
  const float* xr = x + (size_t)row * (size_t)n;
  uint8_t* orow = out + (size_t)row * (size_t)n;
  I carry = -1;  // the last change boundary before the chunk, encoded
  for (I base = 0; base < n; base += kChunk) {
    const I q = base + (I)(kPer * lane);
    float v[kPer + 1];
#pragma unroll
    for (int k = 0; k <= kPer; ++k) v[k] = q + k < n ? xr[q + k] : 0.f;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (q + k < n) orow[q + k] = 0;
    }
    // boundary j = q + k sits between samples j and j + 1
    I code[kPer];
    bool fall[kPer];
    I lane_max = -1;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const I j = q + k;
      const bool inside = j <= n - 2;
      const float a = v[k], b = v[k + 1];
      code[k] = inside && b != a ? j * 2 + (b > a ? 1 : 0) : (I)-1;
      fall[k] = inside && b < a;
      lane_max = code[k] > lane_max ? code[k] : lane_max;
    }
    I incl = lane_max;  // inclusive max-scan of the lanes' codes
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const I t = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl = t > incl ? t : incl;
    }
    I run = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) run = -1;
    run = carry > run ? carry : run;
    const I total = __shfl_sync(kFull, incl, 31);
    __syncwarp();  // the chunk's zeros before any mark
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      // run: the code of the last change boundary before q + k
      if (fall[k] && run >= 0 && (run & 1)) orow[((run >> 1) + 1 + q + k) >> 1] = 1;
      run = code[k] > run ? code[k] : run;
    }
    carry = total > carry ? total : carry;
  }
}

// the row's sample j, from shared memory or device memory
template <bool kShared>
__device__ __forceinline__ float sample(const float* row, int j) {
  if (kShared) return row[j];
  return __ldg(row + j);
}

// minimum and maximum that propagate NaN; a tie keeps a
__device__ __forceinline__ float nan_min(float a, float b) { return (b != b || b < a) ? b : a; }
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a) ? a : ((b != b || b > a) ? b : a);
}

struct Prominence {
  template <bool kShared>
  __device__ __forceinline__ float operator()(const float* xr, long long, int n, int p) const {
    const float xp = sample<kShared>(xr, p);
    float lb = xp, rb = xp;
    for (int j = p - 1; j >= 0; --j) {
      const float v = sample<kShared>(xr, j);
      if (v > xp) break;
      lb = nan_min(lb, v);
    }
    for (int j = p + 1; j < n; ++j) {
      const float v = sample<kShared>(xr, j);
      if (v > xp) break;
      rb = nan_min(rb, v);
    }
    return __fsub_rn(xp, nan_max(lb, rb));
  }
};

struct Width {
  const float* prom;  // (rows, n), row-major
  float rel;
  template <bool kShared>
  __device__ __forceinline__ float operator()(const float* xr, long long row, int n,
                                              int p) const {
    const float xp = sample<kShared>(xr, p);
    const float h = __fsub_rn(xp, __fmul_rn(rel, __ldg(prom + (size_t)row * n + p)));
    int il = -1;  // the last j < p with x[j] <= h
    for (int j = p - 1; j >= 0; --j) {
      if (sample<kShared>(xr, j) <= h) {
        il = j;
        break;
      }
    }
    int ir = n;  // the first j > p with x[j] <= h
    for (int j = p + 1; j < n; ++j) {
      if (sample<kShared>(xr, j) <= h) {
        ir = j;
        break;
      }
    }
    float left = 0.f, right = (float)(n - 1);
    if (il >= 0) {
      const float a = __fadd_rn(sample<kShared>(xr, il), 0.f);
      const float b = __fadd_rn(sample<kShared>(xr, min(il + 1, n - 1)), 0.f);
      const float t = a < h ? __fdiv_rn(__fsub_rn(h, a), b != a ? __fsub_rn(b, a) : 1.f) : 0.f;
      left = __fadd_rn((float)il, t);
    }
    if (ir < n) {
      const float a = __fadd_rn(sample<kShared>(xr, ir), 0.f);
      const float b = __fadd_rn(sample<kShared>(xr, max(ir - 1, 0)), 0.f);
      const float t = a < h ? __fdiv_rn(__fsub_rn(h, a), b != a ? __fsub_rn(b, a) : 1.f) : 0.f;
      right = __fsub_rn((float)ir, t);
    }
    return __fsub_rn(right, left);
  }
};

// K12 and K13: a warp a row; +0.0 off the peaks, op(row, p) at each peak
template <bool kShared, class Op>
__global__ void __launch_bounds__(kWarps * 32)
peak_walk_kernel(const float* __restrict__ x, const uint8_t* __restrict__ is_peak,
                 float* __restrict__ out, long long rows, int n, Op op) {
  extern __shared__ float staged[];
  __shared__ int queue[kWarps][kQueue];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row = (long long)blockIdx.x * kWarps + warp;
  if (row >= rows) return;  // whole warps: nothing below waits on the block
  const float* xg = x + (size_t)row * n;
  const uint8_t* pr = is_peak + (size_t)row * n;
  float* orow = out + (size_t)row * n;
  const float* xr = xg;
  if (kShared) {
    float* s = staged + (size_t)warp * n;
    for (int i = lane; i < n; i += 32) s[i] = xg[i];
    xr = s;
    __syncwarp();
  }
  int* qw = queue[warp];
  const unsigned lt = (1u << lane) - 1u;
  int fill = 0;
  for (int base = 0; base < n; base += 32) {
    const int p = base + lane;
    const bool pk = p < n && pr[p] != 0;
    if (p < n && !pk) orow[p] = 0.f;
    const unsigned b = __ballot_sync(kFull, pk);
    if (pk) qw[fill + __popc(b & lt)] = p;
    fill += __popc(b);
    __syncwarp();
    if (fill >= 32) {
      const int mine = qw[lane], rest = fill - 32;
      const int moved = lane < rest ? qw[32 + lane] : 0;
      __syncwarp();
      if (lane < rest) qw[lane] = moved;
      fill = rest;
      orow[mine] = op.template operator()<kShared>(xr, row, n, mine);
      __syncwarp();
    }
  }
  if (lane < fill) {
    const int mine = qw[lane];
    orow[mine] = op.template operator()<kShared>(xr, row, n, mine);
  }
}

template <class Op>
int launch_walk(const float* x, const uint8_t* is_peak, float* out, long long rows, int n, Op op,
                void* stream) {
  if (rows <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (n <= kSharedMax) {
    const size_t smem = (size_t)kWarps * n * sizeof(float);
    peak_walk_kernel<true, Op><<<(unsigned)blocks, kWarps * 32, smem, (cudaStream_t)stream>>>(
        x, is_peak, out, rows, n, op);
  } else {
    peak_walk_kernel<false, Op><<<(unsigned)blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
        x, is_peak, out, rows, n, op);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// K11: out (rows, n) bytes, 1 at the local maxima of x (rows, n), n >= 3
extern "C" int apt_local_maxima(const float* x, uint8_t* out, long long rows, long long n,
                                void* stream) {
  if (rows <= 0 || n < 3) return (int)cudaErrorInvalidValue;
  const long long blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (n < (1LL << 30)) {
    local_maxima_kernel<int><<<(unsigned)blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
        x, out, rows, (int)n);
  } else {
    local_maxima_kernel<long long><<<(unsigned)blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
        x, out, rows, n);
  }
  return (int)cudaGetLastError();
}

// K12: out (rows, n), the prominence at each peak of is_peak (bytes), +0.0 elsewhere
extern "C" int apt_peak_prominences(const float* x, const uint8_t* is_peak, float* out,
                                    long long rows, int n, void* stream) {
  return launch_walk(x, is_peak, out, rows, n, Prominence{}, stream);
}

// K13: out (rows, n), the width at rel_height of each peak, +0.0 elsewhere
extern "C" int apt_peak_widths_rel(const float* x, const uint8_t* is_peak, const float* prom,
                                   float* out, long long rows, int n, float rel_height,
                                   void* stream) {
  return launch_walk(x, is_peak, out, rows, n, Width{prom, rel_height}, stream);
}
