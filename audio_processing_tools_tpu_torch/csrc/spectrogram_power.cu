// K1: fused Hann window + real DFT + power spectrogram, hand-written for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel `_power_kernel`
// (audio_processing_tools_tpu/ops/spectrogram.py:77-96, launched by
// `_pallas_power`, pallas_call at :126) behind `spectrogram_power`.
//
//   P[b, f, t] = (sum_k Wcos[f, k] x_t[k])^2 + (sum_k Wsin[f, k] x_t[k])^2
//   x_t[k]     = x[b, t*hop + k - pad], zero outside [0, N)
//
// with pad = n_fft/2 for the centered, zero-padded STFT framing (0 when not
// centered).  Wcos/Wsin are the rows of the window+DFT matrix
// (`_dft_matrix_t`), window folded in.
//
// What bounds it on this card: at the production batch (B = 128 clips of
// N = 111,620 samples, T = 873 frames, F = 129 bins, n_fft = 256) the product
// is 2 * 258 * 256 FLOP per frame, 14.8 GFLOP per batch, against ~57 MB read
// and ~58 MB written: ~128 FLOP/B, so fp32 FMA issue and shared-memory
// bandwidth bound it, not HBM.  The whole (2F, n_fft) matrix is 264 KB
// (278,528 B in the TPU kernel's 8-padded layout), more than the 227 KB a
// block may use, so a block holds only its tile of bins.
//
// Design (simple first):
//  * grid (frame tiles of 64, bin tiles of 32, clips); 256 threads = 8 warps.
//    Lane = bin within the tile, warp = frame group; a thread accumulates the
//    cos and sin sums of its bin for 8 frames (warp + 8j).
//  * The block stages its (64 - 1) * hop + n_fft samples in shared memory
//    once, with the centre zero padding folded into masked loads, so no
//    padded copy is ever written to device memory; and its 32 cos and sin
//    rows in a [k/4][bin] float4 layout (64 KB at n_fft = 256).
//  * Inner loop, per 4 taps: each lane reads one float4 of cos and one of sin
//    (consecutive lanes, conflict-free) and each of its frames' 4 samples as
//    one float4 that the whole warp shares (a broadcast): 64 FMAs for 10
//    shared loads.
//  * The power tile goes back through shared memory so that the store to
//    P[b, f, t], t fastest, is coalesced.
// No library call: the product is this kernel's own FMA loop.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBinTile = 32;
constexpr int kFramesPerThread = 8;
constexpr int kFrameTile = kWarps * kFramesPerThread;  // 64
constexpr int kOutStride = kFrameTile + 1;              // padded: no bank conflicts

__host__ __device__ inline int samples_per_block(int n_fft, int hop) {
  return (kFrameTile - 1) * hop + n_fft;
}

__global__ void __launch_bounds__(kThreads)
spectrogram_power_kernel(const float* __restrict__ x,
                         const float* __restrict__ wcos,
                         const float* __restrict__ wsin,
                         float* __restrict__ out,
                         int N, int F, int T, int n_fft, int hop, int pad) {
  extern __shared__ float4 smem4[];
  const int k4n = n_fft / 4;
  float4* wc_s = smem4;                       // [k4n][kBinTile]
  float4* ws_s = smem4 + k4n * kBinTile;      // [k4n][kBinTile]
  float* xs = reinterpret_cast<float*>(smem4 + 2 * k4n * kBinTile);
  const int xs_len = samples_per_block(n_fft, hop);
  float* tile = xs + ((xs_len + 3) & ~3);     // [kBinTile][kOutStride]

  const int t0 = blockIdx.x * kFrameTile;
  const int f0 = blockIdx.y * kBinTile;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // window+DFT rows of this bin tile; bins past F read as zero
  const float4* wcos4 = reinterpret_cast<const float4*>(wcos);
  const float4* wsin4 = reinterpret_cast<const float4*>(wsin);
  for (int i = threadIdx.x; i < kBinTile * k4n; i += kThreads) {
    const int bin = i % kBinTile;
    const int k4 = i / kBinTile;
    const int f = f0 + bin;
    float4 c = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 s = c;
    if (f < F) {
      c = wcos4[(size_t)f * k4n + k4];
      s = wsin4[(size_t)f * k4n + k4];
    }
    wc_s[k4 * kBinTile + bin] = c;
    ws_s[k4 * kBinTile + bin] = s;
  }
  // the block's samples; the zero padding is a masked load
  const float* xb = x + (size_t)b * N;
  const long long g0 = (long long)t0 * hop - pad;
  for (int i = threadIdx.x; i < xs_len; i += kThreads) {
    const long long g = g0 + i;
    xs[i] = (g >= 0 && g < N) ? xb[g] : 0.f;
  }
  __syncthreads();

  float ac[kFramesPerThread];
  float as[kFramesPerThread];
#pragma unroll
  for (int j = 0; j < kFramesPerThread; ++j) {
    ac[j] = 0.f;
    as[j] = 0.f;
  }
  const float4* xs4 = reinterpret_cast<const float4*>(xs);
  const int hop4 = hop / 4;
  for (int k4 = 0; k4 < k4n; ++k4) {
    const float4 c = wc_s[k4 * kBinTile + lane];
    const float4 s = ws_s[k4 * kBinTile + lane];
#pragma unroll
    for (int j = 0; j < kFramesPerThread; ++j) {
      const float4 v = xs4[(warp + kWarps * j) * hop4 + k4];
      ac[j] = fmaf(c.x, v.x, ac[j]);
      ac[j] = fmaf(c.y, v.y, ac[j]);
      ac[j] = fmaf(c.z, v.z, ac[j]);
      ac[j] = fmaf(c.w, v.w, ac[j]);
      as[j] = fmaf(s.x, v.x, as[j]);
      as[j] = fmaf(s.y, v.y, as[j]);
      as[j] = fmaf(s.z, v.z, as[j]);
      as[j] = fmaf(s.w, v.w, as[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kFramesPerThread; ++j) {
    tile[lane * kOutStride + warp + kWarps * j] = ac[j] * ac[j] + as[j] * as[j];
  }
  __syncthreads();

  for (int i = threadIdx.x; i < kBinTile * kFrameTile; i += kThreads) {
    const int bin = i / kFrameTile;
    const int tt = i - bin * kFrameTile;
    const int f = f0 + bin;
    const int t = t0 + tt;
    if (f < F && t < T) {
      out[((size_t)b * F + f) * T + t] = tile[bin * kOutStride + tt];
    }
  }
}

}  // namespace

extern "C" int apt_spectrogram_power(const float* x, const float* wcos,
                                     const float* wsin, float* out, int B,
                                     int N, int F, int T, int n_fft, int hop,
                                     int pad, void* stream) {
  if (n_fft % 4 != 0 || hop % 4 != 0 || B <= 0 || T <= 0 || F <= 0 ||
      B > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int xs_len = samples_per_block(n_fft, hop);
  const size_t smem =
      sizeof(float) * ((size_t)2 * n_fft * kBinTile + ((xs_len + 3) & ~3) +
                       (size_t)kBinTile * kOutStride);
  cudaError_t err = cudaFuncSetAttribute(
      spectrogram_power_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + kFrameTile - 1) / kFrameTile,
                  (F + kBinTile - 1) / kBinTile, B);
  spectrogram_power_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, wcos, wsin, out, N, F, T, n_fft, hop, pad);
  return (int)cudaGetLastError();
}

extern "C" const char* apt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
