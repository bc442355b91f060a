// K1: fused Hann window + real FFT + power spectrogram, hand-written for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel `_power_kernel`
// (audio_processing_tools_tpu/ops/spectrogram.py:77-96, launched by
// `_pallas_power`, pallas_call at :126) behind `spectrogram_power`.
//
//   P[b, f, t] = |sum_k w[k] x_t[k] e^{-2 pi i f k / n_fft}|^2,  f <= n_fft/2
//   x_t[k]     = x[b, t*hop + k - pad], zero outside [0, N)
//
// with pad = n_fft/2 for the centred, zero-padded STFT framing (0 when not
// centred) and w the periodic Hann window.
//
// What bounds it on this card: at the production batch (B = 128 clips of
// N = 111,620 samples, T = 873 frames, F = 129 bins, n_fft = 256) the kernel
// must read 57.1 MB of samples and write 57.7 MB of power: 34 us at the
// H100's 3.35 TB/s.  The TPU kernel's DFT-as-matrix-product costs
// 2 * 258 * 256 FLOP per frame (14.8 GFLOP per batch), which on Hopper's
// fp32 FMA units (no full-fp32 tensor-core mode) is far above that floor.
// An FFT costs ~6 kFLOP per frame (~0.7 GFLOP per batch, ~6 FLOP per byte),
// so the design is a single pass through device memory.
//
// Design:
//  * Real input as a half-length complex FFT: z[m] = w[2m] x[2m] +
//    i w[2m+1] x[2m+1], Z = FFT_M(z) with M = n_fft/2, then
//      X[k] = 1/2 (Z[k] + conj Z[M-k]) - i/2 e^{-2 pi i k / n_fft} (Z[k] - conj Z[M-k])
//    for k = 0..M (Z[M] = Z[0]).  One frame per transform: packing two
//    frames into one complex FFT would tie a quiet frame's error to a loud
//    neighbour's energy.
//  * The FFT is a Stockham auto-sort transform by a group of G = M/8
//    threads, 8 points per thread in registers: a radix-8 pass, a second
//    radix-8 (radix-4 at M = 32) pass and, for M > 64, a third pass of
//    radix M/64.  Passes exchange through a per-frame buffer in shared
//    memory, XOR-swizzled so the strided Stockham writes hit distinct
//    banks; groups of <= 32 threads synchronise with __syncwarp only.
//    Window, pass and split twiddles stay in registers for the whole
//    kernel (each thread always works the same indices).  Twiddles and
//    window are host tables built in float64 and rounded to float32: no
//    fast-math sines anywhere.
//  * Persistent blocks (as many as fit on the card) walk over work items
//    (clip, tile of `frame_tile` frames).  The samples of the next item,
//    (frame_tile - 1) * hop + n_fft of them, are copied into the second of
//    two shared buffers with cp.async while the current item is
//    transformed: 16-byte copies where the source is 16-byte aligned and
//    inside the clip, 4-byte copies with zero fill elsewhere, so the
//    centre padding is a masked load and no padded copy exists.
//  * The (F, frame_tile) power tile goes back through shared memory and is
//    stored with t fastest (coalesced); (B, F, T) rows of T floats are not
//    16-byte multiples in general, so there is no bulk store.
// No library call: the transform is this kernel's own code.

#include <cuda_runtime.h>

#include <cstdint>

#include "stockham_fft.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use

// The launch plan (mirrored by ops/spectrogram.py::launch_plan).
__host__ __device__ constexpr int exch_stride(int M) { return M + 8; }  // float2 per frame
__host__ __device__ constexpr int tile_stride(int frame_tile, int G) {
  return ((frame_tile + 31) & ~31) + (G < 32 ? 32 / G : 1);
}
__host__ __device__ constexpr int slab_floats(int n_fft, int hop, int frame_tile) {
  return (frame_tile - 1) * hop + n_fft;
}
size_t smem_bytes_for(int n_fft, int hop, int frame_tile) {
  const int M = n_fft / 2, G = M / 8, fpr = kThreads / G;
  return 4 * 2 * (size_t)slab_floats(n_fft, hop, frame_tile) +
         8 * (size_t)fpr * exch_stride(M) +
         4 * (size_t)(M + 1) * tile_stride(frame_tile, G);
}

// Pass 1 (radix 8, NS = 1): windowed, packed samples of one frame.
template <int M>
__device__ __forceinline__ void first_pass(const float* frame, float2* buf, int t,
                                           const float2 (&win)[8]) {
  constexpr int G = M / 8;
  float2 v[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const float2 s = *reinterpret_cast<const float2*>(frame + 2 * (t + r * G));
    v[r] = make_float2(s.x * win[r].x, s.y * win[r].y);
  }
  first_radix8<M>(v, buf, t);
}

// Power of bins k = t + q*G (and k = M by thread 0) from Z in `buf`.
template <int M>
__device__ __forceinline__ void split_power(const float2* buf, int t, const float2 (&tws)[8],
                                            float* col, int os, bool live) {
  constexpr int G = M / 8;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int k = t + q * G;
    const float2 zk = buf[swz(k)];
    const float2 zm = buf[swz((M - k) & (M - 1))];
    const float ar = 0.5f * (zk.x + zm.x), ai = 0.5f * (zk.y - zm.y);
    const float dr = 0.5f * (zk.x - zm.x), di = 0.5f * (zk.y + zm.y);
    const float2 w = tws[q];
    const float xr = ar + (w.x * di + w.y * dr);
    const float xi = ai - (w.x * dr - w.y * di);
    if (live) col[k * os] = xr * xr + xi * xi;
  }
  if (t == 0) {
    const float2 z0 = buf[swz(0)];
    const float d = z0.x - z0.y;
    if (live) col[M * os] = d * d;
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start copying the samples of work item `item` into `dst` (shared).
__device__ __forceinline__ void load_slab(const float* __restrict__ x, float* dst, int item,
                                          int N, int hop, int pad, int frame_tile,
                                          int n_tiles, int S) {
  const int b = item / n_tiles;
  const int t0 = (item - b * n_tiles) * frame_tile;
  const long long g0 = (long long)t0 * hop - pad;
  const float* xb = x + (size_t)b * N;
  const bool aligned = (((reinterpret_cast<uintptr_t>(xb) >> 2) + (uintptr_t)g0) & 3) == 0;
  const uint32_t sdst = (uint32_t)__cvta_generic_to_shared(dst);
  for (int c = threadIdx.x; c < S / 4; c += kThreads) {
    const long long s = g0 + 4LL * c;
    if (aligned && s >= 0 && s + 4 <= N) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sdst + 16 * c),
                   "l"(xb + s));
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long g = s + e;
        const bool in = g >= 0 && g < N;
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(sdst + 16 * c + 4 * e),
                     "l"(in ? xb + g : xb), "r"(in ? 4 : 0));
      }
    }
  }
}

template <int M>
__global__ void __launch_bounds__(kThreads)
spectrogram_power_fft(const float* __restrict__ x, const float* __restrict__ window,
                      const float2* __restrict__ twiddle, float* __restrict__ out, int N,
                      int T, int hop, int pad, int frame_tile, int lg_tile, int n_tiles,
                      int n_items) {
  constexpr int n_fft = 2 * M, F = M + 1, G = M / 8, FPR = kThreads / G;
  constexpr int R2 = M / 8 < 8 ? M / 8 : 8;
  constexpr int R3 = M > 64 ? M / 64 : 1;
  extern __shared__ float4 smem4[];
  const int S = slab_floats(n_fft, hop, frame_tile);
  float* const slab0 = reinterpret_cast<float*>(smem4);
  float2* const exch = reinterpret_cast<float2*>(slab0 + 2 * S);
  float* const tile = reinterpret_cast<float*>(exch + FPR * exch_stride(M));
  const int os = tile_stride(frame_tile, G);
  const int t = threadIdx.x % G;
  const int slot = threadIdx.x / G;
  float2* const buf = exch + slot * exch_stride(M);

  float2 win[8], tw2[8], tw3[8], tws[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int m = t + r * G;
    win[r] = make_float2(__ldg(window + 2 * m), __ldg(window + 2 * m + 1));
    tws[r] = __ldg(twiddle + t + r * G);
  }
  pass_twiddles<M, R2, 8>(twiddle, t, tw2);
  if constexpr (M > 64) pass_twiddles<M, R3, 64>(twiddle, t, tw3);

  int item = blockIdx.x;
  int cur = 0;
  if (item < n_items) load_slab(x, slab0, item, N, hop, pad, frame_tile, n_tiles, S);
  cp_async_commit();
  for (; item < n_items; item += gridDim.x) {
    const int next = item + gridDim.x;
    if (next < n_items)
      load_slab(x, slab0 + (cur ^ 1) * S, next, N, hop, pad, frame_tile, n_tiles, S);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // this item's samples have landed; the tile is free

    const float* sl = slab0 + cur * S;
    for (int r0 = 0; r0 < frame_tile; r0 += FPR) {
      const int tt = r0 + slot;
      const bool live = tt < frame_tile;
      first_pass<M>(sl + (live ? tt : 0) * hop, buf, t, win);
      stockham_pass<M, R2, 8>(buf, t, tw2);
      if constexpr (M > 64) stockham_pass<M, R3, 64>(buf, t, tw3);
      split_power<M>(buf, t, tws, tile + tt, os, live);
      group_sync<G>();
    }
    __syncthreads();  // the tile is complete; this slab may be refilled

    const int b = item / n_tiles;
    const int t0 = (item - b * n_tiles) * frame_tile;
    const int nt = min(frame_tile, T - t0);
    float* ob = out + (size_t)b * F * T + t0;
    const int tc = threadIdx.x & (frame_tile - 1);
    if (tc < nt) {
      for (int f = threadIdx.x >> lg_tile; f < F; f += kThreads >> lg_tile)
        ob[(size_t)f * T + tc] = tile[f * os + tc];
    }
    cur ^= 1;
  }
  cp_async_wait<0>();
}

template <int M>
cudaError_t launch(const float* x, const float* window, const float* twiddle, float* out,
                   int B, int N, int T, int hop, int pad, int frame_tile, size_t smem,
                   cudaStream_t stream) {
  // blocks that fit on one SM, cached per (device, shared-memory size)
  static int cached_dev = -1, cached_blocks = 0;
  static size_t cached_smem = 0;
  auto kernel = spectrogram_power_fft<M>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != cached_dev || smem != cached_smem) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cached_dev = dev;
    cached_smem = smem;
    cached_blocks = per_sm * sms;
  }
  int lg_tile = 0;
  while ((1 << lg_tile) < frame_tile) ++lg_tile;
  const int n_tiles = (T + frame_tile - 1) / frame_tile;
  const long long n_items = (long long)B * n_tiles;
  if (n_items > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int grid = (int)(n_items < cached_blocks ? n_items : cached_blocks);
  kernel<<<grid, kThreads, smem, stream>>>(x, window, reinterpret_cast<const float2*>(twiddle),
                                           out, N, T, hop, pad, frame_tile, lg_tile, n_tiles,
                                           (int)n_items);
  return cudaGetLastError();
}

}  // namespace

// window: n_fft floats; twiddle: n_fft (re, im) pairs, e^{-2 pi i k / n_fft};
// frame_tile and smem_bytes: the plan of ops/spectrogram.py::launch_plan,
// which must equal this file's own.
extern "C" int apt_spectrogram_power(const float* x, const float* window, const float* twiddle,
                                     float* out, int B, int N, int T, int n_fft, int hop,
                                     int pad, int frame_tile, int smem_bytes, void* stream) {
  const bool pow2_tile = frame_tile >= 1 && frame_tile <= kThreads && (frame_tile & (frame_tile - 1)) == 0;
  if (hop < 4 || hop % 4 != 0 || !pow2_tile || B <= 0 || T <= 0 || N < 0 || pad < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_fft < 64 || n_fft > 1024 || (n_fft & (n_fft - 1)) != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes_for(n_fft, hop, frame_tile);
  if (smem != (size_t)smem_bytes || smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (n_fft) {
    case 64: return (int)launch<32>(x, window, twiddle, out, B, N, T, hop, pad, frame_tile, smem, s);
    case 128: return (int)launch<64>(x, window, twiddle, out, B, N, T, hop, pad, frame_tile, smem, s);
    case 256: return (int)launch<128>(x, window, twiddle, out, B, N, T, hop, pad, frame_tile, smem, s);
    case 512: return (int)launch<256>(x, window, twiddle, out, B, N, T, hop, pad, frame_tile, smem, s);
    default: return (int)launch<512>(x, window, twiddle, out, B, N, T, hop, pad, frame_tile, smem, s);
  }
}

extern "C" const char* apt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
