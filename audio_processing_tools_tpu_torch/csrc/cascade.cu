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
// 3.35 TB/s.  The in-block sums are ~2 x (64 + 2S) operations per sample
// (~5 GFLOP at S = 4, 73 us at 67 TFLOP/s of float32 outside the tensor
// cores); they run in parallel over (clip, block, sample).  The walk is a
// chain of 872 steps of one 2S-term row each per clip, ~2S dependent adds of
// 4 cycles: ~28 us at 1.98 GHz for S = 4.
//
// Design: three launches on the caller's stream.
//  1. drifts: a CUDA block stages 16 blocks of one clip in shared memory
//     (one coalesced read of x) and one thread per (block, state component)
//     sums its 128 terms;
//  2. the walk: one warp per clip; thread t < 2S keeps row t of A^128 in
//     registers, the state is exchanged by shuffles, and the drifts are
//     loaded eight steps ahead so their latency stays off the chain; it
//     writes every block-start state and the final state;
//  3. outputs: a CUDA block of 128 threads per 8 blocks of one clip, one
//     thread per output sample, the block's samples, its start state and
//     L's column in shared memory.
// A single launch would run the walk's 872 steps after the drifts of the
// whole clip in one place; three keep each part as wide as it is.
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
constexpr int kMaxState = 16;    // 2 S, S <= 8 sections
constexpr int kDriftItems = 16;  // blocks per CUDA block in the drift pass
constexpr int kDriftThreads = 256;
constexpr int kOutItems = 8;     // blocks per CUDA block in the output pass
constexpr int kWalkLanes = 4;    // clips (warps) per CUDA block in the walk
constexpr int kAhead = 8;        // drifts loaded ahead of the walk
constexpr unsigned kFull = 0xffffffffu;

// table layout (ops/filters.py::_k4_flat_tables), float32:
//   toe[kBlock] | K[kBlock][n] | Z[kBlock][n] | A[n][n] | Ap[n][n]
__host__ __device__ constexpr int off_K() { return kBlock; }
__host__ __device__ constexpr int off_Z(int n) { return kBlock + kBlock * n; }
__host__ __device__ constexpr int off_A(int n) { return kBlock + 2 * kBlock * n; }
__host__ __device__ constexpr int off_Ap(int n) { return kBlock + 2 * kBlock * n + n * n; }

__global__ void __launch_bounds__(kDriftThreads)
cascade_drifts(const float* __restrict__ x, const float* __restrict__ tab,
               float* __restrict__ c, long long T, int nb, int n, int n_tiles) {
  __shared__ float xs[kDriftItems][kBlock + 1];
  __shared__ float ks[kBlock * kMaxState];
  const int r = blockIdx.x / n_tiles;
  const int j0 = (blockIdx.x - r * n_tiles) * kDriftItems;
  for (int i = threadIdx.x; i < kBlock * n; i += kDriftThreads) ks[i] = tab[off_K() + i];
  const float* xr = x + (long long)r * T;
  for (int i = threadIdx.x; i < kDriftItems * kBlock; i += kDriftThreads) {
    const int it = i / kBlock, u = i - it * kBlock;
    const long long s = (long long)(j0 + it) * kBlock + u;
    xs[it][u] = s < T ? xr[s] : 0.f;
  }
  __syncthreads();
  const int it = threadIdx.x / n, t = threadIdx.x - it * n;
  if (it >= kDriftItems || j0 + it >= nb) return;
  float acc = __fmul_rn(xs[it][0], ks[t]);
  for (int u = 1; u < kBlock; ++u) acc = __fadd_rn(acc, __fmul_rn(xs[it][u], ks[u * n + t]));
  c[((long long)r * nb + j0 + it) * n + t] = acc;
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

template <int N>
__global__ void __launch_bounds__(kBlock)
cascade_out(const float* __restrict__ x, const float* __restrict__ tab,
            const float* __restrict__ zs, float* __restrict__ y, long long T, int nb,
            int n_tiles) {
  __shared__ float toe[kBlock];
  __shared__ float xs[kBlock];
  __shared__ float zsh[N];
  const int r = blockIdx.x / n_tiles;
  const int jt = (blockIdx.x - r * n_tiles) * kOutItems;
  const int i = threadIdx.x;
  toe[i] = tab[i];
  float zrow[N];
#pragma unroll
  for (int s = 0; s < N; ++s) zrow[s] = tab[off_Z(N) + i * N + s];
  const float* xr = x + (long long)r * T;
  float* yr = y + (long long)r * T;
  for (int it = 0; it < kOutItems && jt + it < nb; ++it) {
    const int j = jt + it;
    const long long s0 = (long long)j * kBlock;
    __syncthreads();  // the previous block's reads are done
    xs[i] = s0 + i < T ? xr[s0 + i] : 0.f;
    if (i < N) zsh[i] = zs[((long long)r * nb + j) * N + i];
    __syncthreads();
    float acc = __fmul_rn(xs[0], toe[i]);
    for (int u = 1; u <= i; ++u) acc = __fadd_rn(acc, __fmul_rn(xs[u], toe[i - u]));
    float acc2 = __fmul_rn(zsh[0], zrow[0]);
#pragma unroll
    for (int s = 1; s < N; ++s) acc2 = __fadd_rn(acc2, __fmul_rn(zsh[s], zrow[s]));
    if (s0 + i < T) yr[s0 + i] = __fadd_rn(acc, acc2);
  }
}

template <int N>
cudaError_t launch(const float* x, const float* tables, const float* zi, float* y, float* zf,
                   float* c, float* zs, int R, long long T, int nb, int P, cudaStream_t st) {
  const int d_tiles = (nb + kDriftItems - 1) / kDriftItems;
  const int o_tiles = (nb + kOutItems - 1) / kOutItems;
  if ((long long)R * d_tiles > 0x7fffffffLL || (long long)R * o_tiles > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cascade_drifts<<<R * d_tiles, kDriftThreads, 0, st>>>(x, tables, c, T, nb, N, d_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cascade_walk<N><<<(R + kWalkLanes - 1) / kWalkLanes, 32 * kWalkLanes, 0, st>>>(
      x, tables, zi, c, zs, zf, R, T, nb, P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cascade_out<N><<<R * o_tiles, kBlock, 0, st>>>(x, tables, zs, y, T, nb, o_tiles);
  return cudaGetLastError();
}

}  // namespace

// x, y: (R, T) contiguous; zi, zf: (R, 2S); tables: _k4_flat_tables for
// P = T - 128 (nb - 1); c, zs: (R, nb, 2S) scratch (the drifts and the
// block-start states).  1 <= S <= 8.
extern "C" int apt_cascade_sosfilt(const float* x, const float* tables, const float* zi, float* y,
                                   float* zf, float* c, float* zs, int R, long long T, int S,
                                   void* stream) {
  if (R <= 0 || T <= 0 || S < 1 || 2 * S > kMaxState) return (int)cudaErrorInvalidValue;
  const long long nbl = (T + kBlock - 1) / kBlock;
  if (nbl * kMaxState > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
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
    default: return (int)launch<16>(x, tables, zi, y, zf, c, zs, R, T, nb, P, st);
  }
}
