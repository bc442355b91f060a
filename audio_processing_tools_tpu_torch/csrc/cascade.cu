// K4: the whole biquad cascade with the sequential block boundary, scipy's
// `sosfilt(sos, x, zi=zi)` -> (y, zf) in the cascade's block form,
// hand-written for Hopper (sm_90a).
//
// It replaces `_sosfilt_cascade_matmul(boundary="scan")`
// (audio_processing_tools_tpu/ops/filters.py:518-650, the boundary
// recurrence `lax.scan` at :620-626, the partial-block final state at
// :637-648), which the band-noise estimator runs for its high-pass and
// band-pass filters (models/band_noise.py:201, 205, 311, 317).  With the
// cascade's 2S-state A, Bv, r, d0 (ops/filters.py::_cascade_state_space) and
// blocks of 128 samples:
//
//   c_j     = sum_u Kblk[u] x_j[u]                      block drift
//   z_{j+1} = A^128 z_j + c_j,  z_0 = zi                boundary walk
//   y_j[i]  = sum_{u<=i} L[i-u] x_j[u] + Zmat[i] . z_j  in-block output
//
// L is Toeplitz (the in-block impulse response), so its first column is the
// whole matrix.  A last block of P < 128 real samples ends in
// zf = A^P z_last + sum_{u<P} Kblk[128-P+u] x_last[u].
//
// What bounds it on this card.  At band noise's batch (128 clips x 111,616
// samples, 872 blocks) the kernel must read x and write y: 114 MB, 34 us at
// 3.35 TB/s.  The in-block sums are ~64 + 4S products per sample and as
// many sums, each its own instruction (no FMA: the bits): ~2.3e9 thread
// instructions at S = 4, 69 us at one warp instruction per scheduler and
// clock (132 x 4 at 1.98 GHz), so the output pass is bound by issue once
// its operands come from registers; they run in parallel over (clip, block,
// sample).  The walk is a chain of 872 steps of one 2S-term row each per
// clip, ~2S dependent adds of 4 cycles: ~28 us at 1.98 GHz for S = 4.
//
// Design: three launches on the caller's stream.
//  1. drifts: a CUDA block takes 32 consecutive blocks of the flattened
//     (clip, block) index, one per lane, their samples staged in shared
//     memory (one coalesced read of x); warp w sums state components
//     4w .. 4w + 3 of every lane's block, x[u] read by the lane for its own
//     block and the four weights Kblk[u] read as one broadcast;
//  2. the walk: one warp, alone in its CUDA block, per clip; thread t < 2S
//     keeps row t of A^128 in registers, the state is exchanged by
//     shuffles, and the drifts are loaded eight steps ahead so their
//     latency stays off the chain; it writes every block-start state and
//     the final state;
//  3. outputs, a register window: a CUDA block takes 32 blocks the same
//     way; each thread computes a window of 8 consecutive outputs of its
//     lane's block.  The 8 Toeplitz taps slide through registers: for
//     each 8 input samples x[u], read by the lane as two 16-byte loads, the
//     8 new taps come as two 16-byte broadcasts, so shared memory serves
//     one load per 16 products where a thread per output needed two per
//     product.  All lanes of a warp work the same window, so they take the
//     same number of steps; warp w works windows w and 15 - w, so every
//     warp takes the same number of steps, whatever its place in the
//     triangle.  The outputs go back through shared memory, in the samples'
//     place, and are stored coalesced (a lane's own stores would touch 32
//     sectors per warp instruction: on an H100 0.26 ms of the pass at band
//     noise's batch, against 0.12 ms this way).
// A single launch would run the walk's 872 steps after the drifts of the
// whole clip in one place; three keep each part as wide as it is.
//
// Width.  The three kernels are instantiated for every state width 2S up to
// kMaxState = 32 (S <= 16 sections), the state in registers and a walk lane
// per component.  A wider cascade takes the same three passes with the
// width a run-time value (the *_wide kernels): the drifts four components a
// warp at a time, the walk one block a clip with the state in shared memory
// (double-buffered, a barrier a block step), the outputs reading their
// block-start states and Zmat from device memory; the sums are the same
// left-to-right sums in the same order, so every width gives the plain
// version's bits.
//
// Arithmetic: every dot product is a left-to-right sum of separately rounded
// products (__fmul_rn / __fadd_rn, never contracted into an FMA) in the
// order of the plain version (ops/filters.py::_cascade_sosfilt_plain), so
// the kernel gives its bits; and a block's arithmetic does not depend on
// where the stream was cut, so chunks of multiples of 128 samples give the
// bits of one call.  No library product: cuBLAS picks its algorithm by shape.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;      // samples per block of the cascade form
constexpr int kMaxState = 32;    // 2 S in registers, S <= 16 sections; wider: the *_wide kernels
constexpr int kLanes = 32;       // blocks per CUDA block in the drift and output passes
constexpr int kRow = kBlock + 4; // floats per staged block: x[u] at 3 + u, so x[1 + 4i] is 16-byte aligned
constexpr int kDriftThreads = 256;  // warp w < 2S / 4: state components 4w .. 4w + 3
constexpr int kWin = 8;          // outputs per thread in the output pass
constexpr int kWins = kBlock / kWin;
constexpr int kOutThreads = 32 * kWins / 2;  // warp w: windows w and kWins - 1 - w
constexpr int kWalkLanes = 1;    // clips (warps) per CUDA block in the walk: one, 0.054 ms on
                                 // an H100 at 128 x 111,616, 4 sections, against 0.091 with four
constexpr int kAhead = 8;        // drifts loaded ahead of the walk
constexpr unsigned kFull = 0xffffffffu;

// table layout (ops/filters.py::_k4_flat_tables), float32:
//   toe[kBlock] | K[kBlock][n] | Z[kBlock][n] | A[n][n] | Ap[n][n]
__host__ __device__ constexpr int off_K() { return kBlock; }
__host__ __device__ constexpr int off_Z(int n) { return kBlock + kBlock * n; }
__host__ __device__ constexpr int off_A(int n) { return kBlock + 2 * kBlock * n; }
__host__ __device__ constexpr int off_Ap(int n) { return kBlock + 2 * kBlock * n + n * n; }

// Stage the samples of kLanes consecutive blocks of the flattened (clip,
// block) index, g0 .. g0 + 31, into xs[lane * kRow + 3 + u], zero past a
// clip's end (the plain version's padding of a last partial block).  The
// first warp finds each lane's block: its offset in x (and y) and its
// samples, `src` and `lim` in shared memory.  Each thread then issues all
// of its loads before it stores any, so a block has 4,096 loads in flight.
template <int kThreads>
__device__ __forceinline__ void stage_blocks(const float* __restrict__ x, float* xs,
                                             long long* src, int* lim, long long g0,
                                             long long n_items, long long T, int nb) {
  constexpr int kPer = kLanes * kBlock / kThreads;
  if (threadIdx.x < kLanes) {
    const long long g = g0 + threadIdx.x;
    long long off = 0;
    int n = 0;
    if (g < n_items) {
      const long long r = g / nb, s = (g - r * nb) * kBlock;
      off = r * T + s;
      n = (int)min((long long)kBlock, T - s);
    }
    src[threadIdx.x] = off;
    lim[threadIdx.x] = n;
  }
  __syncthreads();
  float v[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = threadIdx.x + k * kThreads, lane = i / kBlock, u = i % kBlock;
    v[k] = u < lim[lane] ? x[src[lane] + u] : 0.f;
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = threadIdx.x + k * kThreads;
    xs[i / kBlock * kRow + 3 + i % kBlock] = v[k];
  }
}

template <int N>
__global__ void __launch_bounds__(kDriftThreads)
cascade_drifts(const float* __restrict__ x, const float* __restrict__ tab,
               float* __restrict__ c, long long T, int nb, long long n_items) {
  constexpr int NP = (N + 3) & ~3;  // components padded to whole float4s
  __shared__ __align__(16) float xs[kLanes * kRow];
  __shared__ __align__(16) float ks[kBlock * NP];
  __shared__ long long src[kLanes];
  __shared__ int lim[kLanes];
  const long long g0 = (long long)blockIdx.x * kLanes;
  for (int i = threadIdx.x; i < kBlock * NP; i += kDriftThreads) {
    const int u = i / NP, t = i - u * NP;
    ks[i] = t < N ? tab[off_K() + u * N + t] : 0.f;
  }
  stage_blocks<kDriftThreads>(x, xs, src, lim, g0, n_items, T, nb);
  __syncthreads();
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (4 * w >= N) return;  // the whole warp
  const float* xr = xs + lane * kRow + 3;
  const float4* k4 = reinterpret_cast<const float4*>(ks) + w;
  float4 kv = k4[0];
  const float x0 = xr[0];
  float a0 = __fmul_rn(x0, kv.x), a1 = __fmul_rn(x0, kv.y);
  float a2 = __fmul_rn(x0, kv.z), a3 = __fmul_rn(x0, kv.w);
  for (int u = 1; u < kBlock; ++u) {
    const float xu = xr[u];
    kv = k4[u * (NP / 4)];
    a0 = __fadd_rn(a0, __fmul_rn(xu, kv.x));
    a1 = __fadd_rn(a1, __fmul_rn(xu, kv.y));
    a2 = __fadd_rn(a2, __fmul_rn(xu, kv.z));
    a3 = __fadd_rn(a3, __fmul_rn(xu, kv.w));
  }
  const long long g = g0 + lane;
  if (g >= n_items) return;
  float* cg = c + g * N + 4 * w;
  const float acc[4] = {a0, a1, a2, a3};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (4 * w + i < N) cg[i] = acc[i];
}

// sum_s M[t][s] z[s], left to right; z[s] is lane s's value.  The N
// shuffles do not depend on each other and are issued first.
template <int N>
__device__ __forceinline__ float row_dot(const float (&m)[N], float z) {
  float zz[N];
#pragma unroll
  for (int s = 0; s < N; ++s) zz[s] = __shfl_sync(kFull, z, s);
  float acc = __fmul_rn(zz[0], m[0]);
#pragma unroll
  for (int s = 1; s < N; ++s) acc = __fadd_rn(acc, __fmul_rn(zz[s], m[s]));
  return acc;
}

template <int N>
__global__ void __launch_bounds__(32 * kWalkLanes)
cascade_walk(const float* __restrict__ x, const float* __restrict__ tab,
             const float* __restrict__ zi, const float* __restrict__ c,
             float* __restrict__ zs, float* __restrict__ zf, int R, long long T, int nb, int P) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWalkLanes + (threadIdx.x >> 5);
  if (r >= R) return;  // the whole warp
  const bool act = lane < N;
  const int t = act ? lane : 0;
  float a[N];
#pragma unroll
  for (int s = 0; s < N; ++s) a[s] = tab[off_A(N) + t * N + s];
  float z = zi[(long long)r * N + t];
  // this thread's component of the clip's drifts and block-start states
  const float* cr = c + (long long)r * nb * N + t;
  float* zr = zs + (long long)r * nb * N + t;
  // the last block's state comes from A^P when it holds P < 128 samples
  const int steps = P == kBlock ? nb : nb - 1;
  float cb[kAhead];
#pragma unroll
  for (int k = 0; k < kAhead; ++k) cb[k] = act && k < nb ? cr[k * N] : 0.f;
  for (int j0 = 0; j0 < nb; j0 += kAhead) {
    float cn[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int j = j0 + kAhead + k;
      cn[k] = act && j < nb ? cr[j * N] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int j = j0 + k;
      if (j < nb) {
        if (act) zr[j * N] = z;
        if (j < steps) z = __fadd_rn(row_dot<N>(a, z), cb[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) cb[k] = cn[k];
  }
  if (P == kBlock) {
    if (act) zf[(long long)r * N + t] = z;
    return;
  }
  // z is the last block's start state: advance it exactly P samples
  const float* xl = x + (long long)r * T + (long long)(nb - 1) * kBlock;
  const float* K = tab + off_K() + (kBlock - P) * N;
  float d = 0.f;
  if (act) {
    d = __fmul_rn(xl[0], K[t]);
    for (int u = 1; u < P; ++u) d = __fadd_rn(d, __fmul_rn(xl[u], K[u * N + t]));
  }
#pragma unroll
  for (int s = 0; s < N; ++s) a[s] = tab[off_Ap(N) + t * N + s];
  const float acc = row_dot<N>(a, z);
  if (act) zf[(long long)r * N + t] = __fadd_rn(acc, d);
}

// One window of kWin outputs, y[i0 + j] for j < kWin, of the lane's block:
// acc[j] = sum_{u <= i0 + j} x[u] L[i0 + j - u], left to right in u.
// `xr` is the lane's staged block (x[u] at xr[u]), `toe` L's column.
__device__ __forceinline__ void toeplitz_window(const float* xr, const float* toe, int i0,
                                                float (&acc)[kWin]) {
  const float x0 = xr[0];
  float tt[2 * kWin];  // tt[7 + j - uu]: the tap of output j at step u = g + uu
#pragma unroll
  for (int j = 0; j < kWin; ++j) acc[j] = __fmul_rn(x0, toe[i0 + j]);
  *reinterpret_cast<float4*>(tt + kWin) = *reinterpret_cast<const float4*>(toe + i0);
  *reinterpret_cast<float4*>(tt + kWin + 4) = *reinterpret_cast<const float4*>(toe + i0 + 4);
  // u = 1 .. i0 in groups of kWin: every output of the window takes them
  for (int g = 1; g <= i0; g += kWin) {
    const int base = i0 - g + 1 - kWin;  // taps base .. base + 2 kWin - 1
    *reinterpret_cast<float4*>(tt) = *reinterpret_cast<const float4*>(toe + base);
    *reinterpret_cast<float4*>(tt + 4) = *reinterpret_cast<const float4*>(toe + base + 4);
    float xv[kWin];
    *reinterpret_cast<float4*>(xv) = *reinterpret_cast<const float4*>(xr + g);
    *reinterpret_cast<float4*>(xv + 4) = *reinterpret_cast<const float4*>(xr + g + 4);
#pragma unroll
    for (int uu = 0; uu < kWin; ++uu) {
#pragma unroll
      for (int j = 0; j < kWin; ++j)
        acc[j] = __fadd_rn(acc[j], __fmul_rn(xv[uu], tt[kWin - 1 + j - uu]));
    }
#pragma unroll
    for (int j = 0; j < kWin; ++j) tt[kWin + j] = tt[j];
  }
  // u = i0 + d, d = 1 .. kWin - 1: outputs j >= d, tap L[j - d]
  float xv[kWin];
  *reinterpret_cast<float4*>(xv) = *reinterpret_cast<const float4*>(xr + i0 + 1);
  *reinterpret_cast<float4*>(xv + 4) = *reinterpret_cast<const float4*>(xr + i0 + 5);
#pragma unroll
  for (int d = 1; d < kWin; ++d) {
#pragma unroll
    for (int j = d; j < kWin; ++j) acc[j] = __fadd_rn(acc[j], __fmul_rn(xv[d - 1], toe[j - d]));
  }
}

template <int N>
__global__ void __launch_bounds__(kOutThreads)
cascade_out(const float* __restrict__ x, const float* __restrict__ tab,
            const float* __restrict__ zs, float* __restrict__ y, long long T, int nb,
            long long n_items) {
  __shared__ __align__(16) float xs[kLanes * kRow];  // the blocks' x, then their y
  __shared__ __align__(16) float toe[kBlock];
  __shared__ float zm[kBlock * N];
  __shared__ long long src[kLanes];
  __shared__ int lim[kLanes];
  const long long g0 = (long long)blockIdx.x * kLanes;
  for (int i = threadIdx.x; i < kBlock; i += kOutThreads) toe[i] = tab[i];
  for (int i = threadIdx.x; i < kBlock * N; i += kOutThreads) zm[i] = tab[off_Z(N) + i];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long g = g0 + lane;
  float z[N];
#pragma unroll
  for (int s = 0; s < N; ++s) z[s] = g < n_items ? zs[g * N + s] : 0.f;
  stage_blocks<kOutThreads>(x, xs, src, lim, g0, n_items, T, nb);
  __syncthreads();
  const float* xr = xs + lane * kRow + 3;
  float out[2][kWin];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i0 = kWin * (h == 0 ? w : kWins - 1 - w);
    toeplitz_window(xr, toe, i0, out[h]);
#pragma unroll
    for (int j = 0; j < kWin; ++j) {
      const float* zr = zm + (i0 + j) * N;
      float acc2 = __fmul_rn(z[0], zr[0]);
#pragma unroll
      for (int s = 1; s < N; ++s) acc2 = __fadd_rn(acc2, __fmul_rn(z[s], zr[s]));
      out[h][j] = __fadd_rn(out[h][j], acc2);
    }
  }
  // y through shared memory, in x's place, so the stores are coalesced
  __syncthreads();
  float* const ys = xs + lane * kRow + 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i0 = kWin * (h == 0 ? w : kWins - 1 - w);
#pragma unroll
    for (int j = 0; j < kWin; ++j) ys[i0 + j] = out[h][j];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kLanes * kBlock; i += kOutThreads) {
    const int l = i / kBlock, u = i % kBlock;
    if (u < lim[l]) y[src[l] + u] = xs[l * kRow + 3 + u];
  }
}

// ---------------------------------------------------------------------------
// Cascades wider than kMaxState: the state width a run-time value
// ---------------------------------------------------------------------------

constexpr int kWideWalkThreads = 256;

__global__ void __launch_bounds__(kDriftThreads)
cascade_drifts_wide(const float* __restrict__ x, const float* __restrict__ tab,
                    float* __restrict__ c, long long T, int nb, long long n_items, int N) {
  __shared__ __align__(16) float xs[kLanes * kRow];
  __shared__ long long src[kLanes];
  __shared__ int lim[kLanes];
  const long long g0 = (long long)blockIdx.x * kLanes;
  stage_blocks<kDriftThreads>(x, xs, src, lim, g0, n_items, T, nb);
  __syncthreads();
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* xr = xs + lane * kRow + 3;
  const long long g = g0 + lane;
  const float* const K = tab + off_K();
  for (int c0 = 4 * w; c0 < N; c0 += 4 * (kDriftThreads / 32)) {
    const int nc = min(4, N - c0);
    const float x0 = xr[0];
    float a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = i < nc ? __fmul_rn(x0, __ldg(K + c0 + i)) : 0.f;
    for (int u = 1; u < kBlock; ++u) {
      const float xu = xr[u];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (i < nc) a[i] = __fadd_rn(a[i], __fmul_rn(xu, __ldg(K + u * N + c0 + i)));
    }
    if (g < n_items) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (i < nc) c[g * N + c0 + i] = a[i];
    }
  }
}

// sum_s M[t][s] z[s], left to right, M's row t read from device memory
__device__ __forceinline__ float row_dot_wide(const float* __restrict__ mrow, const float* z,
                                              int N) {
  float acc = __fmul_rn(z[0], __ldg(mrow));
  for (int s = 1; s < N; ++s) acc = __fadd_rn(acc, __fmul_rn(z[s], __ldg(mrow + s)));
  return acc;
}

__global__ void __launch_bounds__(kWideWalkThreads)
cascade_walk_wide(const float* __restrict__ x, const float* __restrict__ tab,
                  const float* __restrict__ zi, const float* __restrict__ c,
                  float* __restrict__ zs, float* __restrict__ zf, long long T, int nb, int P,
                  int N) {
  extern __shared__ float zsh[];  // [2][N]: the state, by block parity
  const int r = blockIdx.x;
  const float* const A = tab + off_A(N);
  const float* const cr = c + (long long)r * nb * N;
  float* const zr = zs + (long long)r * nb * N;
  for (int t = threadIdx.x; t < N; t += blockDim.x) zsh[t] = zi[(long long)r * N + t];
  __syncthreads();
  const int steps = P == kBlock ? nb : nb - 1;
  int cur = 0;
  for (int j = 0; j < nb; ++j) {
    const float* const z = zsh + cur * N;
    for (int t = threadIdx.x; t < N; t += blockDim.x) {
      zr[(long long)j * N + t] = z[t];
      if (j < steps) zsh[(cur ^ 1) * N + t] = __fadd_rn(row_dot_wide(A + t * N, z, N),
                                                        cr[(long long)j * N + t]);
    }
    __syncthreads();
    if (j < steps) cur ^= 1;
  }
  const float* const z = zsh + cur * N;
  if (P == kBlock) {
    for (int t = threadIdx.x; t < N; t += blockDim.x) zf[(long long)r * N + t] = z[t];
    return;
  }
  // z is the last block's start state: advance it exactly P samples
  const float* xl = x + (long long)r * T + (long long)(nb - 1) * kBlock;
  const float* K = tab + off_K() + (kBlock - P) * N;
  for (int t = threadIdx.x; t < N; t += blockDim.x) {
    float d = __fmul_rn(xl[0], K[t]);
    for (int u = 1; u < P; ++u) d = __fadd_rn(d, __fmul_rn(xl[u], K[u * N + t]));
    zf[(long long)r * N + t] = __fadd_rn(row_dot_wide(tab + off_Ap(N) + t * N, z, N), d);
  }
}

__global__ void __launch_bounds__(kOutThreads)
cascade_out_wide(const float* __restrict__ x, const float* __restrict__ tab,
                 const float* __restrict__ zs, float* __restrict__ y, long long T, int nb,
                 long long n_items, int N) {
  __shared__ __align__(16) float xs[kLanes * kRow];  // the blocks' x, then their y
  __shared__ __align__(16) float toe[kBlock];
  __shared__ long long src[kLanes];
  __shared__ int lim[kLanes];
  const long long g0 = (long long)blockIdx.x * kLanes;
  for (int i = threadIdx.x; i < kBlock; i += kOutThreads) toe[i] = tab[i];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long g = g0 + lane;
  const float* const z = zs + (g < n_items ? g : 0) * N;
  stage_blocks<kOutThreads>(x, xs, src, lim, g0, n_items, T, nb);
  __syncthreads();
  const float* xr = xs + lane * kRow + 3;
  float out[2][kWin];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i0 = kWin * (h == 0 ? w : kWins - 1 - w);
    toeplitz_window(xr, toe, i0, out[h]);
#pragma unroll
    for (int j = 0; j < kWin; ++j) {
      const float* zr = tab + off_Z(N) + (i0 + j) * N;
      float acc2 = __fmul_rn(z[0], __ldg(zr));
      for (int s = 1; s < N; ++s) acc2 = __fadd_rn(acc2, __fmul_rn(z[s], __ldg(zr + s)));
      out[h][j] = __fadd_rn(out[h][j], acc2);
    }
  }
  __syncthreads();
  float* const ys = xs + lane * kRow + 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i0 = kWin * (h == 0 ? w : kWins - 1 - w);
#pragma unroll
    for (int j = 0; j < kWin; ++j) ys[i0 + j] = out[h][j];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kLanes * kBlock; i += kOutThreads) {
    const int l = i / kBlock, u = i % kBlock;
    if (u < lim[l]) y[src[l] + u] = xs[l * kRow + 3 + u];
  }
}

cudaError_t launch_wide(const float* x, const float* tables, const float* zi, float* y,
                        float* zf, float* c, float* zs, int R, long long T, int nb, int P, int N,
                        cudaStream_t st) {
  const long long n_items = (long long)R * nb;
  const long long tiles = (n_items + kLanes - 1) / kLanes;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  cascade_drifts_wide<<<(int)tiles, kDriftThreads, 0, st>>>(x, tables, c, T, nb, n_items, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int smem = 2 * N * (int)sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(cascade_walk_wide, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const int threads = min(kWideWalkThreads, (N + 31) / 32 * 32);
  cascade_walk_wide<<<R, threads, smem, st>>>(x, tables, zi, c, zs, zf, T, nb, P, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cascade_out_wide<<<(int)tiles, kOutThreads, 0, st>>>(x, tables, zs, y, T, nb, n_items, N);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch(const float* x, const float* tables, const float* zi, float* y, float* zf,
                   float* c, float* zs, int R, long long T, int nb, int P, cudaStream_t st) {
  const long long n_items = (long long)R * nb;
  const long long tiles = (n_items + kLanes - 1) / kLanes;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  cascade_drifts<N><<<(int)tiles, kDriftThreads, 0, st>>>(x, tables, c, T, nb, n_items);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cascade_walk<N><<<(R + kWalkLanes - 1) / kWalkLanes, 32 * kWalkLanes, 0, st>>>(
      x, tables, zi, c, zs, zf, R, T, nb, P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cascade_out<N><<<(int)tiles, kOutThreads, 0, st>>>(x, tables, zs, y, T, nb, n_items);
  return cudaGetLastError();
}

}  // namespace

// x, y: (R, T) contiguous; zi, zf: (R, 2S); tables: _k4_flat_tables for
// P = T - 128 (nb - 1); c, zs: (R, nb, 2S) scratch (the drifts and the
// block-start states).  S >= 1: up to 16 sections the state in registers,
// more the *_wide kernels.
extern "C" int apt_cascade_sosfilt(const float* x, const float* tables, const float* zi, float* y,
                                   float* zf, float* c, float* zs, int R, long long T, int S,
                                   void* stream) {
  if (R <= 0 || T <= 0 || S < 1 || 2LL * S * 2 * S > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const long long nbl = (T + kBlock - 1) / kBlock;
  if (nbl * 2 * S > 0x7fffffffLL || 2 * S * (long long)sizeof(float) * 2 > 232448)
    return (int)cudaErrorInvalidValue;
  const int nb = (int)nbl;
  const int P = (int)(T - (long long)(nb - 1) * kBlock);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (S) {
    case 1: return (int)launch<2>(x, tables, zi, y, zf, c, zs, R, T, nb, P, st);
    case 2: return (int)launch<4>(x, tables, zi, y, zf, c, zs, R, T, nb, P, st);
    case 3: return (int)launch<6>(x, tables, zi, y, zf, c, zs, R, T, nb, P, st);
    case 4: return (int)launch<8>(x, tables, zi, y, zf, c, zs, R, T, nb, P, st);
    case 5: return (int)launch<10>(x, tables, zi, y, zf, c, zs, R, T, nb, P, st);
    case 6: return (int)launch<12>(x, tables, zi, y, zf, c, zs, R, T, nb, P, st);
    case 7: return (int)launch<14>(x, tables, zi, y, zf, c, zs, R, T, nb, P, st);
    case 8: return (int)launch<16>(x, tables, zi, y, zf, c, zs, R, T, nb, P, st);
    case 9: return (int)launch<18>(x, tables, zi, y, zf, c, zs, R, T, nb, P, st);
    case 10: return (int)launch<20>(x, tables, zi, y, zf, c, zs, R, T, nb, P, st);
    case 11: return (int)launch<22>(x, tables, zi, y, zf, c, zs, R, T, nb, P, st);
    case 12: return (int)launch<24>(x, tables, zi, y, zf, c, zs, R, T, nb, P, st);
    case 13: return (int)launch<26>(x, tables, zi, y, zf, c, zs, R, T, nb, P, st);
    case 14: return (int)launch<28>(x, tables, zi, y, zf, c, zs, R, T, nb, P, st);
    case 15: return (int)launch<30>(x, tables, zi, y, zf, c, zs, R, T, nb, P, st);
    case 16: return (int)launch<32>(x, tables, zi, y, zf, c, zs, R, T, nb, P, st);
    default: return (int)launch_wide(x, tables, zi, y, zf, c, zs, R, T, nb, P, 2 * S, st);
  }
}
