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
//
// The mixed route (apt_spectrogram_power_mixed) takes every even n_fft
// whose half has no odd prime factor above 31 (mixed_fft.cuh), any hop >= 1:
// the TPU kernel's own geometry set (n_fft = 128 m, m <= 32, hop n_fft / 2)
// and the power-of-two sizes at a hop that is not a multiple of 4.  One
// block a tile of 2^lg frames of one clip: the tile's samples come in with
// 16-byte loads into one of two shared buffers, the windowed, packed frames
// go frame-fastest into the other, the mixed-radix Stockham passes run
// between the two, and each thread writes the split and power of one bin of
// one frame, consecutive lanes consecutive frames.  Its bound is the
// function's, by bytes (at 128 x 10 s about 57 MB in and 58 MB out at
// 384/192 or 2,048/1,024: ~0.034 ms at 3.35 TB/s); an FFT's ~5 n log2 n
// FLOP a frame keep it there.
//
// The DFT route (apt_spectrogram_power_dft) takes every other geometry the
// JAX package runs, any n_fft >= 1 and hop >= 1 (an odd n_fft, a prime
// factor above 31): the TPU kernel's own
// window-and-DFT product (dft.cuh), one block a tile of frames of one clip.
// The tile's windowed samples and the twiddle table sit in shared memory,
// frame-fastest, and each thread sums bin k for FPT frames at once, n_fft
// FMAs a frame and part, from the twiddles (k m) mod n_fft of the table.
// The function's bound is the same; this route does the DFT's 4 n_fft FLOP
// a bin and frame, so it runs far above it.

#include <cuda_runtime.h>

#include <cstdint>

#include "dft.cuh"
#include "mixed_fft.cuh"
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

// ---------------------------------------------------------------------------
// The DFT route: one block a tile of FPT * G frames of one clip; thread u
// sums bin u % F for frames (u / F) FPT .. + FPT - 1, and the next units.
// ---------------------------------------------------------------------------

// frames a block holds and whether the twiddles fit beside them; the last
// plan, one frame's samples, sets ops/spectrogram.py::DFT_MAX_N_FFT
struct DftPlan {
  int fpt, groups;
  bool tw_shared;
  size_t smem;
};

__host__ __device__ constexpr size_t dft_samples_bytes(int n_fft, int frames) {
  return (4 * (size_t)n_fft * frames + 15) / 16 * 16;  // the twiddles start 16-byte aligned
}

DftPlan dft_plan_for(int n_fft) {
  const size_t n = (size_t)n_fft;
  const DftPlan plans[4] = {{8, 2, true, dft_samples_bytes(n_fft, 16) + 8 * n},
                            {8, 1, true, dft_samples_bytes(n_fft, 8) + 8 * n},
                            {1, 1, true, dft_samples_bytes(n_fft, 1) + 8 * n},
                            {1, 1, false, dft_samples_bytes(n_fft, 1)}};
  for (const DftPlan& p : plans)
    if (p.smem <= (size_t)kSmemLimit) return p;
  return {0, 0, false, 0};
}

template <int FPT, int G, bool kTwShared>
__global__ void __launch_bounds__(kThreads)
spectrogram_power_dft(const float* __restrict__ x, const float* __restrict__ window,
                      const float2* __restrict__ twiddle, float* __restrict__ out, int N,
                      int T, int n_fft, int hop, int pad, int n_tiles) {
  constexpr int FTB = FPT * G;
  extern __shared__ float4 smem4[];
  float* const xs = reinterpret_cast<float*>(smem4);  // [n_fft][FTB]
  float2* const tws =
      reinterpret_cast<float2*>(reinterpret_cast<char*>(smem4) + dft_samples_bytes(n_fft, FTB));
  const int b = blockIdx.x / n_tiles;
  const int t0 = (blockIdx.x - b * n_tiles) * FTB;
  const float* const xb = x + (size_t)b * N;
  for (int i = threadIdx.x; i < n_fft * FTB; i += kThreads) {
    const int f = i / n_fft, m = i - f * n_fft;
    const long long s = (long long)(t0 + f) * hop + m - pad;
    const float v = (t0 + f < T && s >= 0 && s < N) ? xb[s] : 0.f;
    xs[m * FTB + f] = v * __ldg(window + m);
  }
  if constexpr (kTwShared)
    for (int i = threadIdx.x; i < n_fft; i += kThreads) tws[i] = twiddle[i];
  __syncthreads();
  const float2* const tw = kTwShared ? tws : twiddle;
  const int F = n_fft / 2 + 1;
  for (int u = threadIdx.x; u < F * G; u += kThreads) {
    const int g = u / F, k = u - g * F;
    float re[FPT], im[FPT];
    dft_forward<FPT>(xs, FTB, g * FPT, tw, n_fft, k, re, im);
    float* const o = out + ((size_t)b * F + k) * T + t0 + g * FPT;
#pragma unroll
    for (int f = 0; f < FPT; ++f)
      if (t0 + g * FPT + f < T) o[f] = re[f] * re[f] + im[f] * im[f];
  }
}

template <int FPT, int G, bool kTwShared>
cudaError_t launch_dft(const float* x, const float* window, const float* twiddle, float* out,
                       int B, int N, int T, int n_fft, int hop, int pad, size_t smem,
                       cudaStream_t stream) {
  static int dev_set = -1;
  static size_t smem_set = 0;
  auto kernel = spectrogram_power_dft<FPT, G, kTwShared>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != dev_set || smem > smem_set) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dev_set = dev;
    smem_set = smem;
  }
  const int n_tiles = (T + FPT * G - 1) / (FPT * G);
  if ((long long)B * n_tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<B * n_tiles, kThreads, smem, stream>>>(x, window,
                                                   reinterpret_cast<const float2*>(twiddle), out,
                                                   N, T, n_fft, hop, pad, n_tiles);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The mixed route: one block a tile of 2^lg frames of one clip.
// ---------------------------------------------------------------------------

constexpr int kMixedMaxTile = 32;  // frames a block holds at most

// dynamic shared memory of the mixed route (ops/spectrogram.py::_mixed_smem):
// two tile buffers of M points; the samples are staged in the second
size_t mixed_smem_for(int n_fft, int frame_tile) {
  return 16 * (size_t)tile_elems(n_fft / 2, frame_tile);
}

template <bool kWide>
__global__ void __launch_bounds__(kThreads)
spectrogram_power_mixed(const float* __restrict__ x, const float* __restrict__ window,
                        const float2* __restrict__ twiddle, float* __restrict__ out, int N,
                        int T, int n_fft, int hop, int pad, int lg, int n_tiles, MixedPlan plan) {
  extern __shared__ float4 smem4[];
  const int M = n_fft / 2, F = M + 1, ft = 1 << lg, ld = ft + 1;
  float2* const buf_a = reinterpret_cast<float2*>(smem4);
  float2* const buf_b = buf_a + tile_elems(M, ft);
  const int b = blockIdx.x / n_tiles;
  const int t0 = (blockIdx.x - b * n_tiles) * ft;
  const float* const xb = x + (size_t)b * N;
  const long long g0 = (long long)t0 * hop - pad;
  float* const stage = reinterpret_cast<float*>(buf_b);

  // ---- the tile's samples: one run where frames overlap or touch, else
  // frame by frame; frame f's sample m at slab[f * sh + m] ----
  const float* slab = stage;
  int sh = hop;
  if (hop <= n_fft) {
    slab = stage_run(xb, N, g0, (ft - 1) * hop + n_fft, stage);
  } else {
    sh = n_fft;
    for (int i = threadIdx.x; i < ft * n_fft; i += blockDim.x) {
      const int f = i / n_fft, m = i - f * n_fft;
      const long long s = g0 + (long long)f * hop + m;
      stage[i] = s >= 0 && s < N ? xb[s] : 0.f;
    }
  }
  __syncthreads();
  pack_frames(slab, sh, window, buf_a, M, ft, ld);
  __syncthreads();
  const float2* const Z = mixed_fft<kWide>(buf_a, buf_b, twiddle, n_fft, lg, ld, plan);

  // ---- the real split and the power of bin k of frame f ----
  for (int i = threadIdx.x; i < (F << lg); i += blockDim.x) {
    const int f = i & (ft - 1), k = i >> lg;
    if (t0 + f >= T) continue;
    float p;
    if (k == M) {
      const float2 z0 = Z[f];
      const float d = z0.x - z0.y;
      p = d * d;
    } else {
      const float2 zk = Z[k * ld + f];
      const float2 zm = Z[(k == 0 ? 0 : M - k) * ld + f];
      const float ar = 0.5f * (zk.x + zm.x), ai = 0.5f * (zk.y - zm.y);
      const float dr = 0.5f * (zk.x - zm.x), di = 0.5f * (zk.y + zm.y);
      const float2 w = __ldg(twiddle + k);
      const float xr = ar + (w.x * di + w.y * dr);
      const float xi = ai - (w.x * dr - w.y * di);
      p = xr * xr + xi * xi;
    }
    out[((size_t)b * F + k) * T + t0 + f] = p;
  }
}

template <bool kWide>
cudaError_t launch_mixed(const float* x, const float* window, const float* twiddle, float* out,
                         int B, int N, int T, int n_fft, int hop, int pad, int frame_tile,
                         size_t smem, const MixedPlan& plan, cudaStream_t stream) {
  static int dev_set = -1;
  static size_t smem_set = 0;
  auto kernel = spectrogram_power_mixed<kWide>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != dev_set || smem > smem_set) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dev_set = dev;
    smem_set = smem;
  }
  int lg = 0;
  while ((1 << lg) < frame_tile) ++lg;
  const int n_tiles = (T + frame_tile - 1) / frame_tile;
  if ((long long)B * n_tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<B * n_tiles, kThreads, smem, stream>>>(x, window,
                                                   reinterpret_cast<const float2*>(twiddle), out,
                                                   N, T, n_fft, hop, pad, lg, n_tiles, plan);
  return cudaGetLastError();
}

}  // namespace

// The DFT route: any n_fft >= 1 and hop >= 1 whose plan fits (dft_plan_for);
// tables as for the FFT route.
extern "C" int apt_spectrogram_power_dft(const float* x, const float* window,
                                         const float* twiddle, float* out, int B, int N, int T,
                                         int n_fft, int hop, int pad, void* stream) {
  if (n_fft < 1 || hop < 1 || B <= 0 || T <= 0 || N < 0 || pad < 0)
    return (int)cudaErrorInvalidValue;
  const DftPlan p = dft_plan_for(n_fft);
  if (p.fpt == 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (p.groups == 2)
    return (int)launch_dft<8, 2, true>(x, window, twiddle, out, B, N, T, n_fft, hop, pad, p.smem, s);
  if (p.fpt == 8)
    return (int)launch_dft<8, 1, true>(x, window, twiddle, out, B, N, T, n_fft, hop, pad, p.smem, s);
  if (p.tw_shared)
    return (int)launch_dft<1, 1, true>(x, window, twiddle, out, B, N, T, n_fft, hop, pad, p.smem, s);
  return (int)launch_dft<1, 1, false>(x, window, twiddle, out, B, N, T, n_fft, hop, pad, p.smem, s);
}

// The mixed route: an even n_fft >= 4 whose half has a plan (mixed_plan_of),
// any hop >= 1; frame_tile (a power of two up to kMixedMaxTile) and
// smem_bytes: ops/spectrogram.py::mixed_launch_plan, whose layout must equal
// this file's own (mixed_smem_for).  Tables as for the FFT route.
extern "C" int apt_spectrogram_power_mixed(const float* x, const float* window,
                                           const float* twiddle, float* out, int B, int N, int T,
                                           int n_fft, int hop, int pad, int frame_tile,
                                           int smem_bytes, void* stream) {
  const bool pow2_tile =
      frame_tile >= 1 && frame_tile <= kMixedMaxTile && (frame_tile & (frame_tile - 1)) == 0;
  if (n_fft < 4 || n_fft % 2 != 0 || hop < 1 || !pow2_tile || B <= 0 || T <= 0 || N < 0 ||
      pad < 0)
    return (int)cudaErrorInvalidValue;
  const MixedPlan plan = mixed_plan_of(n_fft / 2);
  if (plan.n_pass == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = mixed_smem_for(n_fft, frame_tile);
  if (smem != (size_t)smem_bytes || smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (plan_is_wide(plan))
    return (int)launch_mixed<true>(x, window, twiddle, out, B, N, T, n_fft, hop, pad, frame_tile,
                                   smem, plan, s);
  return (int)launch_mixed<false>(x, window, twiddle, out, B, N, T, n_fft, hop, pad, frame_tile,
                                  smem, plan, s);
}

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
