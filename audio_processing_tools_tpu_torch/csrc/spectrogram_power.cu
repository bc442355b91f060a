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
// The odd mixed route (apt_spectrogram_power_odd) takes every odd n_fft
// whose factors are all <= 31: the same tiles, with the windowed real frame
// as a complex n-point transform (zero imaginary parts) and bins 0 ..
// (n - 1) / 2 straight out of it; one frame a transform (packing two frames
// as x1 + i x2 would tie a quiet frame's error to a loud neighbour's).
//
// The chirp-z route (apt_spectrogram_power_chirpz) takes every n_fft whose
// complex length L (n / 2 or n) has a prime factor above 31: the same
// tiles (but two frames, not one, where two fit a third of a block's
// shared memory: a single frame's row stride of 1 puts the first passes'
// strided stores on few banks; ops/spectrogram.py::chirpz_launch_plan),
// two buffers of M points a frame, M a 7-smooth size >= L + K - 1
// for the K bins the power reads (K = L for an even n_fft, whose split
// reads every bin; K = F = (n + 1) / 2 for an odd one:
// ops/spectrogram.py::chirp_size); the frame times the chirp, the M-point
// transform, times Bt, the transform again, the chirp (four_step.cuh
// states it).  Two transforms of 1.5L to 2L points a frame or more: ~4x
// the mixed route's work at the same n_fft.
//
// The global route (apt_spectrogram_power_global) takes every size whose
// transform (L, or the chirp-z M) passes kOneBlockPoints: a four-step FFT
// through two chunk buffers in device memory (four_step.cuh), two launches
// a transform, then the power from the spectrum, a tile of frames and bins
// through shared memory.  Frames go through in chunks of at most 32 MiB of
// buffers, which stay in the 50 MB L2.  Its bytes beyond the function's:
// the buffers' writes and reads, ~5x the frame's points in float2 a frame.
//
// The global Rader route (apt_spectrogram_power_rader_global) takes a prime
// L above 31 whose R = L - 1 passes kOneBlockPoints and has a four-step
// split (65,537 = 2^16 + 1): Rader's convolution over R points, each of
// its two transforms a four-step FFT through the chunk buffers, then the
// power with the output permutation, in place of a chirp-z transform over
// 1.5L to 4L points.  For an odd n_fft (a real frame) the first transform
// runs over R / 2 points of packed pairs, the second one's columns
// splitting it as they read it (four_step.cuh).  The input permutation is
// a gather of samples from the clip (in L2: the chunk's frames overlap);
// the window comes in the gather's order from a host table, so only the
// samples are read out of order.  At 65,537/32,768 and 128 x 10 s each
// chunk of 32 frames is five launches, the columns' gathers the largest.
//
// The split route (apt_spectrogram_power_split) takes a complex length L =
// P Q whose chirp-z size passes kOneBlockPoints, P its one prime factor
// above 31 (split_of: 9,999 = 101 x 99, 7,265 = 1,453 x 5): one
// Cooley-Tukey step through the chunk buffers, P's transform in one block a
// column (Rader's convolution over P - 1 points, or a chirp-z transform of
// about 2P points) with the twiddle and Rader's output permutation applied
// as the column is stored, then the rows' Q-point mixed-radix FFTs and the
// power: three launches a chunk over L points, in place of the chirp-z
// global route's five over 1.5L to 2L.
//
// The DFT route (apt_spectrogram_power_dft), which only comparisons force,
// takes any n_fft up to 58,112 and hop >= 1: the TPU kernel's own
// window-and-DFT product (dft.cuh), one block a tile of frames of one clip.
// The tile's windowed samples and the twiddle table sit in shared memory,
// frame-fastest, and each thread sums bin k for FPT frames at once, n_fft
// FMAs a frame and part, from the twiddles (k m) mod n_fft of the table.
// The function's bound is the same; this route does the DFT's 4 n_fft FLOP
// a bin and frame, so it runs far above it: it is the chirp-z and global
// routes' independent check on the card.

#include <cuda_runtime.h>

#include <cstdint>

#include "dft.cuh"
#include "four_step.cuh"
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

// The samples of a tile of ft frames of one clip, from sample g0 on, into
// `stage`: one run where frames overlap or touch, else frame by frame.
// Returns the slab, frame f's sample m at slab[f * sh + m].
__device__ __forceinline__ const float* stage_tile(const float* __restrict__ xb, int N,
                                                   long long g0, int ft, int n_fft, int hop,
                                                   float* stage, int& sh) {
  if (hop <= n_fft) {
    sh = hop;
    return stage_run(xb, N, g0, (ft - 1) * hop + n_fft, stage);
  }
  sh = n_fft;
  for (int i = threadIdx.x; i < ft * n_fft; i += blockDim.x) {
    const int f = i / n_fft, m = i - f * n_fft;
    const long long s = g0 + (long long)f * hop + m;
    stage[i] = s >= 0 && s < N ? xb[s] : 0.f;
  }
  return stage;
}

template <int kW>
__global__ void __launch_bounds__(kThreads)
spectrogram_power_mixed(const float* __restrict__ x, const float* __restrict__ window,
                        const float2* __restrict__ twiddle, float* __restrict__ out, int N,
                        int T, int n_fft, int hop, int pad, int lg, int n_tiles, MixedPlan plan) {
  extern __shared__ float4 smem4[];
  const int M = n_fft / 2, F = M + 1, ft = 1 << lg, ld = tile_ld(ft);
  float2* const buf_a = reinterpret_cast<float2*>(smem4);
  float2* const buf_b = buf_a + tile_elems(M, ft);
  const int b = blockIdx.x / n_tiles;
  const int t0 = (blockIdx.x - b * n_tiles) * ft;
  int sh;
  const float* const slab = stage_tile(x + (size_t)b * N, N, (long long)t0 * hop - pad, ft, n_fft,
                                       hop, reinterpret_cast<float*>(buf_b), sh);
  __syncthreads();
  pack_frames(slab, sh, window, buf_a, M, ft, ld);
  __syncthreads();
  const float2* const Z = mixed_fft<kW>(buf_a, buf_b, twiddle, n_fft, M, lg, ld, plan);

  // ---- the real split and the power of bin k of frame f ----
  for (int i = threadIdx.x; i < (F << lg); i += blockDim.x) {
    const int f = i & (ft - 1), k = i >> lg;
    if (t0 + f >= T) continue;
    out[((size_t)b * F + k) * T + t0 + f] =
        k == M ? nyquist_power(Z[f])
               : split_power(Z[k * ld + f], Z[(k == 0 ? 0 : M - k) * ld + f], __ldg(twiddle + k));
  }
}

// ---------------------------------------------------------------------------
// The odd mixed route: an odd n_fft whose factors are all <= 31, one block
// a tile of 2^lg frames of one clip.  The windowed real frame is the input
// of a complex n-point transform (zero imaginary parts), whose bins 0 ..
// (n - 1) / 2 are the spectrum: no split step.  One frame a transform.
// ---------------------------------------------------------------------------

template <int kW>
__global__ void __launch_bounds__(kThreads)
spectrogram_power_odd(const float* __restrict__ x, const float* __restrict__ window,
                      const float2* __restrict__ twiddle, float* __restrict__ out, int N, int T,
                      int n_fft, int hop, int pad, int lg, int n_tiles, MixedPlan plan) {
  extern __shared__ float4 smem4[];
  const int n = n_fft, F = n / 2 + 1, ft = 1 << lg, ld = tile_ld(ft);
  float2* const buf_a = reinterpret_cast<float2*>(smem4);
  float2* const buf_b = buf_a + tile_elems(n, ft);
  const int b = blockIdx.x / n_tiles;
  const int t0 = (blockIdx.x - b * n_tiles) * ft;
  int sh;
  const float* const slab = stage_tile(x + (size_t)b * N, N, (long long)t0 * hop - pad, ft, n,
                                       hop, reinterpret_cast<float*>(buf_b), sh);
  __syncthreads();
  for (int i = threadIdx.x; i < ft * n; i += blockDim.x) {
    const int f = i / n, m = i - f * n;
    buf_a[m * ld + f] = make_float2(slab[f * sh + m] * __ldg(window + m), 0.f);
  }
  __syncthreads();
  const float2* const Z = mixed_fft<kW>(buf_a, buf_b, twiddle, n, n, lg, ld, plan);
  for (int i = threadIdx.x; i < (F << lg); i += blockDim.x) {
    const int f = i & (ft - 1), k = i >> lg;
    if (t0 + f >= T) continue;
    const float2 z = Z[k * ld + f];
    out[((size_t)b * F + k) * T + t0 + f] = z.x * z.x + z.y * z.y;
  }
}

// ---------------------------------------------------------------------------
// The chirp-z route (four_step.cuh states the transform): every n_fft
// whose complex length L (n / 2 packed for an even n_fft, n for an odd one)
// has a prime factor above 31, one block a tile of 2^lg frames of one clip,
// two M-point buffers a frame.  Per frame: the windowed, packed frame times
// the chirp, zero-padded to M; the forward M-point transform; times Bt and
// conjugated; the transform again; then, for an even n_fft, Z[k] = conj(.)
// times the chirp and the real split, for an odd one the power of conj(.)
// as it is (|c_k| = 1).  M's radices are 2 to 8: never the wide primes.
// For an odd n_fft each transform's last pass does the step after it from
// its registers (TimesConjBt, PowerOfBins): two round trips through shared
// memory and two barriers fewer a frame, and the last pass stores only the
// F bins the power reads.
// ---------------------------------------------------------------------------

// The forward transform's last pass: conj(X Bt) into the other buffer.
struct TimesConjBt {
  const float2* bt;
  __device__ __forceinline__ void operator()(float2* dst, int k, int f, const Tile& ln,
                                             float2 v) const {
    const float2 w = cmul(v, __ldg(bt + k));
    dst[ln.at(k, f)] = make_float2(w.x, -w.y);
  }
};

// The inverse transform's last pass: the power |X_k|^2 of bins k < F of the
// tile's frames f < nf, bin k of frame f at out[k T + f].
struct PowerOfBins {
  float* out;
  int T, F, nf;
  __device__ __forceinline__ void operator()(float2*, int k, int f, const Tile&,
                                             float2 v) const {
    if (k < F && f < nf) out[(size_t)k * T + f] = v.x * v.x + v.y * v.y;
  }
};

template <bool kOdd>
__global__ void __launch_bounds__(kThreads)
spectrogram_power_chirpz(const float* __restrict__ x, const float* __restrict__ window,
                         const float2* __restrict__ twiddle, const float2* __restrict__ chirp,
                         const float2* __restrict__ bt, const float2* __restrict__ ctab,
                         float* __restrict__ out, int N, int T, int n_fft, int hop, int pad,
                         int lg, int n_tiles, int Mc, MixedPlan plan) {
  extern __shared__ float4 smem4[];
  constexpr bool even = !kOdd;
  const int L = even ? n_fft / 2 : n_fft, F = n_fft / 2 + 1, ft = 1 << lg, ld = tile_ld(ft);
  float2* const buf_a = reinterpret_cast<float2*>(smem4);
  float2* const buf_b = buf_a + tile_elems(Mc, ft);
  const int b = blockIdx.x / n_tiles;
  const int t0 = (blockIdx.x - b * n_tiles) * ft;
  int sh;
  const float* const slab = stage_tile(x + (size_t)b * N, N, (long long)t0 * hop - pad, ft, n_fft,
                                       hop, reinterpret_cast<float*>(buf_b), sh);
  __syncthreads();
  for (int i = threadIdx.x; i < ft * Mc; i += blockDim.x) {
    const int f = i / Mc, m = i - f * Mc;
    float2 v = make_float2(0.f, 0.f);
    if (m < L) {
      const float* const s = slab + f * sh;
      v = even ? make_float2(s[2 * m] * __ldg(window + 2 * m),
                             s[2 * m + 1] * __ldg(window + 2 * m + 1))
               : make_float2(s[m] * __ldg(window + m), 0.f);
      v = cmul(v, __ldg(chirp + m));
    }
    buf_a[m * ld + f] = v;
  }
  __syncthreads();
  if constexpr (kOdd) {
    float2* const Y = mixed_fft<7>(buf_a, buf_b, ctab, Mc, Mc, lg, ld, plan, TimesConjBt{bt});
    mixed_fft<7>(Y, Y == buf_a ? buf_b : buf_a, ctab, Mc, Mc, lg, ld, plan,
                 PowerOfBins{out + (size_t)b * F * T + t0, T, F, T - t0});
  } else {
    const float2* const W = chirp_convolve(buf_a, buf_b, ctab, bt, Mc, lg, ld, plan);
    for (int i = threadIdx.x; i < (F << lg); i += blockDim.x) {
      const int f = i & (ft - 1), k = i >> lg;
      if (t0 + f >= T) continue;
      auto z = [&](int j) {
        const float2 w = W[j * ld + f];
        return cmul(make_float2(w.x, -w.y), __ldg(chirp + j));
      };
      out[((size_t)b * F + k) * T + t0 + f] =
          k == L ? nyquist_power(z(0))
                 : split_power(z(k), z(k == 0 ? 0 : L - k), __ldg(twiddle + k));
    }
  }
}

// ---------------------------------------------------------------------------
// The Rader route: a prime complex length L above 31 whose L - 1 has a plan
// (1,009 = 1 + 2^4 3^2 7), one block a tile of 2^lg frames of one clip.
// With g a primitive root mod L, X[g^-q] = z_0 + sum_r z[g^r] e^{-2 pi i
// g^(r-q) / L}: a cyclic convolution over N = L - 1 points of a_r =
// z[g^r] with b_m = e^{-2 pi i g^-m / L}, through the chirp-z route's
// steps (the transform, times Bt = FFT(b) / N, conjugated, the transform
// again, conjugated) over N points, not the ~2L to 4L of chirp-z; and X_0
// = z_0 + A_0, the first transform's bin 0.  The host builds the
// permutations (gin[q] = g^q, qout[k] = q with g^-q = k) and Bt in float64
// (ops/spectrogram.py::rader_tables).
// ---------------------------------------------------------------------------

template <int kW>
__global__ void __launch_bounds__(kThreads)
spectrogram_power_rader(const float* __restrict__ x, const float* __restrict__ window,
                        const float2* __restrict__ twiddle, const int* __restrict__ gin,
                        const int* __restrict__ qout, const float2* __restrict__ bt,
                        const float2* __restrict__ rtab, float* __restrict__ out, int N, int T,
                        int n_fft, int hop, int pad, int lg, int n_tiles, MixedPlan plan) {
  extern __shared__ float4 smem4[];
  const bool even = (n_fft & 1) == 0;
  const int L = even ? n_fft / 2 : n_fft, R = L - 1, F = n_fft / 2 + 1, ft = 1 << lg,
            ld = tile_ld(ft);
  float2* const z0 = reinterpret_cast<float2*>(smem4);  // [ft]: each frame's z_0
  float2* const a0 = z0 + ft;                           // [ft]: each frame's A_0
  float2* const buf_a = a0 + ft;
  float2* const buf_b = buf_a + tile_elems(R, ft);  // 16 bytes more: the staged samples' slack
  const int b = blockIdx.x / n_tiles;
  const int t0 = (blockIdx.x - b * n_tiles) * ft;
  int sh;
  const float* const slab = stage_tile(x + (size_t)b * N, N, (long long)t0 * hop - pad, ft, n_fft,
                                       hop, reinterpret_cast<float*>(buf_b), sh);
  __syncthreads();
  auto point = [&](int f, int j) {  // z_j of frame f, windowed (and packed)
    const float* const s = slab + f * sh;
    return even ? make_float2(s[2 * j] * __ldg(window + 2 * j),
                              s[2 * j + 1] * __ldg(window + 2 * j + 1))
                : make_float2(s[j] * __ldg(window + j), 0.f);
  };
  for (int i = threadIdx.x; i < ft * R; i += blockDim.x) {
    const int f = i / R, q = i - f * R;
    buf_a[q * ld + f] = point(f, __ldg(gin + q));
  }
  for (int f = threadIdx.x; f < ft; f += blockDim.x) z0[f] = point(f, 0);
  __syncthreads();
  const float2* const W = rader_convolve<kW>(buf_a, buf_b, rtab, bt, a0, R, lg, ld, plan);
  for (int i = threadIdx.x; i < (F << lg); i += blockDim.x) {
    const int f = i & (ft - 1), k = i >> lg;
    if (t0 + f >= T) continue;
    auto z = [&](int j) {  // Z[j], j < L
      const float2 c = j == 0 ? a0[f] : W[__ldg(qout + j) * ld + f];
      return make_float2(z0[f].x + c.x, z0[f].y + (j == 0 ? c.y : -c.y));
    };
    float p;
    if (even) {
      p = k == L ? nyquist_power(z(0))
                 : split_power(z(k), z(k == 0 ? 0 : L - k), __ldg(twiddle + k));
    } else {
      const float2 v = z(k);
      p = v.x * v.x + v.y * v.y;
    }
    out[((size_t)b * F + k) * T + t0 + f] = p;
  }
}

// ---------------------------------------------------------------------------
// The global route: the transform of a frame too large for one block, as a
// four-step FFT (four_step.cuh) through two chunk buffers in device memory,
// then the power of each bin from the spectrum in buffer B: a tile of
// kEpiFrames frames by kEpiBins bins goes through shared memory, read bin
// after bin and written frame after frame, so both runs are contiguous.
// ---------------------------------------------------------------------------

constexpr int kEpiFrames = 32, kEpiBins = 64;

// A tile's powers (bin kk, frame f at tile[kk][f]) into out, frame after
// frame along each bin's row.
__device__ __forceinline__ void store_power_tile(float (*tile)[kEpiFrames + 1],
                                                 float* __restrict__ out, int T, int F,
                                                 long long g0, int f0, int k0, int nf) {
  for (int i = threadIdx.x; i < kEpiFrames * kEpiBins; i += blockDim.x) {
    const int kk = i / kEpiFrames, f = i - kk * kEpiFrames, k = k0 + kk;
    if (f0 + f >= nf || k >= F) continue;
    const long long g = g0 + f0 + f, b = g / T;
    out[(b * F + k) * T + (g - b * T)] = tile[kk][f];
  }
}

__global__ void __launch_bounds__(kThreads)
power_from_spectrum(const float2* __restrict__ Z, long long zs, const float2* __restrict__ twiddle,
                    float* __restrict__ out, int T, int F, int M, bool even, long long g0, int nf,
                    int n_btiles) {
  __shared__ float tile[kEpiBins][kEpiFrames + 1];
  const int f0 = (blockIdx.x / n_btiles) * kEpiFrames;
  const int k0 = (blockIdx.x % n_btiles) * kEpiBins;
  for (int i = threadIdx.x; i < kEpiFrames * kEpiBins; i += blockDim.x) {
    const int f = i / kEpiBins, kk = i - f * kEpiBins, k = k0 + kk;
    if (f0 + f >= nf || k >= F) continue;
    const float2* const z = Z + (f0 + f) * zs;
    float p;
    if (even) {
      p = k == M ? nyquist_power(z[0])
                 : split_power(z[k], z[k == 0 ? 0 : M - k], __ldg(twiddle + k));
    } else {
      const float2 v = z[k];
      p = v.x * v.x + v.y * v.y;
    }
    tile[kk][f] = p;
  }
  __syncthreads();
  store_power_tile(tile, out, T, F, g0, f0, k0, nf);
}

// The split route's power of an odd frame from its kept rows (Z: X[k1 + (H
// + 1) k2] for k1 <= H = (P - 1) / 2, a frame every zs points): bin k = k1 +
// P k2 reads its own row, or past H its mirror X[L - k] = conj(X[k]) at row
// P - k1, column Q - 1 - k2 (the same power); then as power_from_spectrum.
__global__ void __launch_bounds__(kThreads)
power_from_half_rows(const float2* __restrict__ Z, long long zs, float* __restrict__ out, int T,
                     int F, int P, int Q, long long g0, int nf, int n_btiles) {
  __shared__ float tile[kEpiBins][kEpiFrames + 1];
  const int f0 = (blockIdx.x / n_btiles) * kEpiFrames;
  const int k0 = (blockIdx.x % n_btiles) * kEpiBins;
  const int H = (P - 1) / 2;
  for (int i = threadIdx.x; i < kEpiFrames * kEpiBins; i += blockDim.x) {
    const int f = i / kEpiBins, kk = i - f * kEpiBins, k = k0 + kk;
    if (f0 + f >= nf || k >= F) continue;
    int k2 = k / P, k1 = k - k2 * P;
    if (k1 > H) {
      k1 = P - k1;
      k2 = Q - 1 - k2;
    }
    const float2 v = Z[(f0 + f) * zs + k1 + (H + 1) * k2];
    tile[kk][f] = v.x * v.x + v.y * v.y;
  }
  __syncthreads();
  store_power_tile(tile, out, T, F, g0, f0, k0, nf);
}

// The global Rader route's power (spectrogram_power_rader_global's last
// launch): W is the second transform's output, X_k = z_0 + conj(W[qout[k]])
// for 0 < k < L and X_0 = z_0 + A_0 (a0), z_0 the frame's first point,
// read through `frame` (gin null); then as power_from_spectrum.
__global__ void __launch_bounds__(kThreads)
power_from_rader(const float2* __restrict__ W, long long zs, const int* __restrict__ qout,
                 const float2* __restrict__ a0, Source frame, const float2* __restrict__ twiddle,
                 float* __restrict__ out, int T, int F, int L, bool even, long long g0, int nf,
                 int n_btiles) {
  __shared__ float tile[kEpiBins][kEpiFrames + 1];
  __shared__ float2 z0[kEpiFrames];
  const int f0 = (blockIdx.x / n_btiles) * kEpiFrames;
  const int k0 = (blockIdx.x % n_btiles) * kEpiBins;
  if (threadIdx.x < kEpiFrames && f0 + (int)threadIdx.x < nf)
    z0[threadIdx.x] = frame(f0 + threadIdx.x, 0);
  __syncthreads();
  for (int i = threadIdx.x; i < kEpiFrames * kEpiBins; i += blockDim.x) {
    const int f = i / kEpiBins, kk = i - f * kEpiBins, k = k0 + kk;
    if (f0 + f >= nf || k >= F) continue;
    const float2* const w = W + (f0 + f) * zs;
    auto z = [&](int j) {  // X_j, j < L
      const float2 c = j == 0 ? a0[f0 + f] : w[__ldg(qout + j)];
      return make_float2(z0[f].x + c.x, z0[f].y + (j == 0 ? c.y : -c.y));
    };
    float p;
    if (even) {
      p = k == L ? nyquist_power(z(0))
                 : split_power(z(k), z(k == 0 ? 0 : L - k), __ldg(twiddle + k));
    } else {
      const float2 v = z(k);
      p = v.x * v.x + v.y * v.y;
    }
    tile[kk][f] = p;
  }
  __syncthreads();
  store_power_tile(tile, out, T, F, g0, f0, k0, nf);
}

// The grid of a tiled route, blocks over (clip, tile of 2^lg frames), once
// `kernel` may take `smem` bytes.
struct Tiles {
  int lg, n_tiles, grid;
};

cudaError_t tiles_for(const void* kernel, int smem, int B, int T, int frame_tile, int& dev_set,
                      int& smem_set, Tiles& t) {
  const cudaError_t err = raise_smem_to(kernel, smem, dev_set, smem_set);
  if (err != cudaSuccess) return err;
  t.lg = 0;
  while ((1 << t.lg) < frame_tile) ++t.lg;
  t.n_tiles = (T + frame_tile - 1) / frame_tile;
  if ((long long)B * t.n_tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  t.grid = B * t.n_tiles;
  return cudaSuccess;
}

// the mixed route (odd = false) and the odd mixed route (odd = true)
template <int kW>
cudaError_t launch_mixed(bool odd, const float* x, const float* window, const float* twiddle,
                         float* out, int B, int N, int T, int n_fft, int hop, int pad,
                         int frame_tile, int smem, const MixedPlan& plan, cudaStream_t stream) {
  static int dev_even = -1, smem_even = 0, dev_odd = -1, smem_odd = 0;
  auto kernel = odd ? spectrogram_power_odd<kW> : spectrogram_power_mixed<kW>;
  Tiles t;
  const cudaError_t err = tiles_for((const void*)kernel, smem, B, T, frame_tile,
                                    odd ? dev_odd : dev_even, odd ? smem_odd : smem_even, t);
  if (err != cudaSuccess) return err;
  kernel<<<t.grid, kThreads, smem, stream>>>(x, window, reinterpret_cast<const float2*>(twiddle),
                                             out, N, T, n_fft, hop, pad, t.lg, t.n_tiles, plan);
  return cudaGetLastError();
}

bool pow2_tile(int frame_tile) {
  return frame_tile >= 1 && frame_tile <= kMixedMaxTile && (frame_tile & (frame_tile - 1)) == 0;
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
  if (n_fft < 4 || n_fft % 2 != 0 || hop < 1 || !pow2_tile(frame_tile) || B <= 0 || T <= 0 ||
      N < 0 || pad < 0)
    return (int)cudaErrorInvalidValue;
  const MixedPlan plan = mixed_plan_of(n_fft / 2);
  if (plan.n_pass == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = mixed_smem_for(n_fft, frame_tile);
  if (smem != (size_t)smem_bytes || smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)by_width(plan, [&](auto w) {
    return launch_mixed<decltype(w)::value>(false, x, window, twiddle, out, B, N, T, n_fft, hop,
                                            pad, frame_tile, (int)smem, plan, s);
  });
}

// The odd mixed route: an odd n_fft >= 3 with a plan (mixed_plan_of), any
// hop >= 1; frame_tile and smem_bytes: ops/spectrogram.py::tile_plan(n_fft)
// (two tile buffers of n_fft points).  Tables as for the FFT route.
extern "C" int apt_spectrogram_power_odd(const float* x, const float* window,
                                         const float* twiddle, float* out, int B, int N, int T,
                                         int n_fft, int hop, int pad, int frame_tile,
                                         int smem_bytes, void* stream) {
  if (n_fft < 3 || n_fft % 2 != 1 || hop < 1 || !pow2_tile(frame_tile) || B <= 0 || T <= 0 ||
      N < 0 || pad < 0)
    return (int)cudaErrorInvalidValue;
  const MixedPlan plan = mixed_plan_of(n_fft);
  if (plan.n_pass == 0) return (int)cudaErrorInvalidValue;
  const long long smem = 16LL * tile_elems(n_fft, frame_tile);
  if (smem != smem_bytes || smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)by_width(plan, [&](auto w) {
    return launch_mixed<decltype(w)::value>(true, x, window, twiddle, out, B, N, T, n_fft, hop,
                                            pad, frame_tile, (int)smem, plan, s);
  });
}

// The chirp-z route: any n_fft >= 1 and hop >= 1, through Mc points
// (ops/spectrogram.py::chirp_size of the complex length L, n_fft / 2 or
// n_fft, and the bins the power reads, L or n_fft / 2 + 1; the launcher
// checks chirp_size_takes); frame_tile and
// smem_bytes: ops/spectrogram.py::chirpz_launch_plan(Mc), two tile buffers
// of Mc points (any power-of-two tile up to kMixedMaxTile whose block
// fits is taken).  chirp: L pairs c_j; bt: Mc
// pairs FFT(b) / Mc; ctab: Mc pairs e^{-2 pi i j / Mc}
// (ops/spectrogram.py::chirpz_tables); the rest as for the FFT route.
extern "C" int apt_spectrogram_power_chirpz(const float* x, const float* window,
                                            const float* twiddle, const float* chirp,
                                            const float* bt, const float* ctab, float* out, int B,
                                            int N, int T, int n_fft, int hop, int pad, int Mc,
                                            int frame_tile, int smem_bytes, void* stream) {
  if (n_fft < 1 || hop < 1 || !pow2_tile(frame_tile) || B <= 0 || T <= 0 || N < 0 || pad < 0 ||
      !chirp_size_takes(n_fft % 2 ? n_fft : n_fft / 2, n_fft % 2 ? n_fft / 2 + 1 : n_fft / 2,
                        Mc))
    return (int)cudaErrorInvalidValue;
  const MixedPlan plan = mixed_plan_of(Mc);
  const long long smem = 16LL * tile_elems(Mc, frame_tile);
  if (smem != smem_bytes || smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  static int dev_set[2] = {-1, -1}, smem_set[2] = {0, 0};
  const int odd = n_fft % 2;
  auto kernel = odd ? spectrogram_power_chirpz<true> : spectrogram_power_chirpz<false>;
  Tiles t;
  const cudaError_t err = tiles_for((const void*)kernel, (int)smem, B, T, frame_tile,
                                    dev_set[odd], smem_set[odd], t);
  if (err != cudaSuccess) return (int)err;
  auto f2 = [](const float* p) { return reinterpret_cast<const float2*>(p); };
  kernel<<<t.grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, window, f2(twiddle), f2(chirp), f2(bt), f2(ctab), out, N, T, n_fft, hop, pad, t.lg,
      t.n_tiles, Mc, plan);
  return (int)cudaGetLastError();
}

// The Rader route: n_fft whose complex length L (n_fft / 2 or n_fft) is a
// prime with a plan for L - 1; frame_tile and smem_bytes:
// ops/spectrogram.py::rader_launch_plan (two float2 a frame, two tile
// buffers of L - 1 points, 16 bytes).  gin: L - 1 ints g^q mod L; qout: L ints, q with
// g^-q = k (qout[0] unused); bt, rtab: L - 1 pairs FFT(b) / (L - 1) and
// e^{-2 pi i j / (L - 1)} (ops/spectrogram.py::rader_tables); the rest as
// for the FFT route.
extern "C" int apt_spectrogram_power_rader(const float* x, const float* window,
                                           const float* twiddle, const int* gin, const int* qout,
                                           const float* bt, const float* rtab, float* out, int B,
                                           int N, int T, int n_fft, int hop, int pad,
                                           int frame_tile, int smem_bytes, void* stream) {
  const int L = n_fft % 2 ? n_fft : n_fft / 2;
  if (n_fft < 1 || hop < 1 || !pow2_tile(frame_tile) || B <= 0 || T <= 0 || N < 0 || pad < 0 ||
      L < 3)
    return (int)cudaErrorInvalidValue;
  const MixedPlan plan = mixed_plan_of(L - 1);
  const long long smem = 16LL * tile_elems(L - 1, frame_tile) + 16LL * frame_tile + 16;
  if (plan.n_pass == 0 || smem != smem_bytes || smem > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  auto f2 = [](const float* p) { return reinterpret_cast<const float2*>(p); };
  return (int)by_width(plan, [&](auto w) {
    static int dev_set = -1, smem_set = 0;
    auto kernel = spectrogram_power_rader<decltype(w)::value>;
    Tiles t;
    cudaError_t err = tiles_for((const void*)kernel, (int)smem, B, T, frame_tile, dev_set,
                                smem_set, t);
    if (err != cudaSuccess) return err;
    kernel<<<t.grid, kThreads, smem, (cudaStream_t)stream>>>(
        x, window, f2(twiddle), gin, qout, f2(bt), f2(rtab), out, N, T, n_fft, hop, pad, t.lg,
        t.n_tiles, plan);
    return cudaGetLastError();
  });
}

// The global route: any n_fft >= 1 and hop >= 1 whose transform of NT points
// the four-step split takes (four_step_of): NT = L, the complex length, with
// chirp null (L has a plan), else NT a chirp-z size with the chirp-z
// tables as for the chirp-z route.  scratch: scratch_bytes of device memory,
// at least the two chunk buffers (16 NT chunk_frames(NT, B T) bytes).
extern "C" int apt_spectrogram_power_global(const float* x, const float* window,
                                            const float* twiddle, const float* chirp,
                                            const float* bt, const float* ctab, float* out, int B,
                                            int N, int T, int n_fft, int hop, int pad, int NT,
                                            float* scratch, long long scratch_bytes,
                                            void* stream) {
  const bool even = n_fft % 2 == 0;
  const int L = even ? n_fft / 2 : n_fft;
  if (n_fft < 1 || hop < 1 || B <= 0 || T <= 0 || N < 0 || pad < 0 || scratch == nullptr ||
      (chirp == nullptr ? NT != L || mixed_plan_of(L).n_pass == 0
                        : !chirp_size_takes(L, even ? L : n_fft / 2 + 1, NT)))
    return (int)cudaErrorInvalidValue;
  const FourStep fs = four_step_of(NT);
  const long long frames = (long long)B * T;
  const long long chunk = chunk_frames(NT, frames);
  if (!fs.ok || 16LL * NT * chunk > scratch_bytes) return (int)cudaErrorInvalidValue;
  auto f2 = [](const float* p) { return reinterpret_cast<const float2*>(p); };
  const float2* const table = chirp == nullptr ? f2(twiddle) : f2(ctab);
  const int tn = chirp == nullptr ? n_fft : NT;
  float2* const A = reinterpret_cast<float2*>(scratch);
  float2* const Bf = A + chunk * NT;
  const cudaStream_t s = (cudaStream_t)stream;
  const int F = n_fft / 2 + 1, n_btiles = (F + kEpiBins - 1) / kEpiBins;
  for (long long g0 = 0; g0 < frames; g0 += chunk) {
    const int nf = (int)(frames - g0 < chunk ? frames - g0 : chunk);
    const Source src{even ? Source::kEvenFrame : Source::kOddFrame, x, N, g0, T, hop, pad, window,
                     nullptr, 0, nullptr, L};
    cudaError_t err = transform_chunk(src, A, Bf, table, tn, f2(chirp), f2(bt), L, even, fs, nf, s);
    if (err != cudaSuccess) return (int)err;
    const long long grid = (long long)((nf + kEpiFrames - 1) / kEpiFrames) * n_btiles;
    if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    power_from_spectrum<<<(int)grid, kThreads, 0, s>>>(Bf, NT, f2(twiddle), out, T, F, L, even,
                                                        g0, nf, n_btiles);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// The global Rader route: an n_fft whose complex length L (n_fft / 2 or
// n_fft) is a prime whose R = L - 1 the four-step split takes (R / 2 too
// where `half`, an odd n_fft only: the first transform over packed pairs);
// gin, qout, bt, rtab: ops/spectrogram.py::rader_tables, as for the Rader
// route; rwin: the window in the gather's order (rader_window: 2R floats
// for an even n_fft, R for an odd one); scratch: scratch_bytes of device
// memory, at least the two chunk buffers and A_0 (16 R + 8 bytes a frame of
// chunk_frames(R, B T)).  Five launches a chunk.
extern "C" int apt_spectrogram_power_rader_global(
    const float* x, const float* window, const float* twiddle, const int* gin, const int* qout,
    const float* bt, const float* rtab, const float* rwin, float* out, int B, int N, int T,
    int n_fft, int hop, int pad, int half, float* scratch, long long scratch_bytes,
    void* stream) {
  const bool even = n_fft % 2 == 0;
  const int L = even ? n_fft / 2 : n_fft, R = L - 1;
  if (n_fft < 1 || hop < 1 || B <= 0 || T <= 0 || N < 0 || pad < 0 || scratch == nullptr ||
      rwin == nullptr || L < 5 || (half && (even || R % 2 != 0)))
    return (int)cudaErrorInvalidValue;
  const FourStep fs = four_step_of(R), fs1 = half ? four_step_of(R / 2) : fs;
  const long long frames = (long long)B * T;
  const long long chunk = chunk_frames(R, frames);
  if (!fs.ok || !fs1.ok || (16LL * R + 8) * chunk > scratch_bytes)
    return (int)cudaErrorInvalidValue;
  auto f2 = [](const float* p) { return reinterpret_cast<const float2*>(p); };
  float2* const A = reinterpret_cast<float2*>(scratch);
  float2* const Bf = A + chunk * R;
  float2* const a0 = Bf + chunk * R;
  const cudaStream_t s = (cudaStream_t)stream;
  const int F = n_fft / 2 + 1, n_btiles = (F + kEpiBins - 1) / kEpiBins;
  const int kind = even ? Source::kEvenFrame : Source::kOddFrame;
  for (long long g0 = 0; g0 < frames; g0 += chunk) {
    const int nf = (int)(frames - g0 < chunk ? frames - g0 : chunk);
    const Source frame{kind, x, N, g0, T, hop, pad, window, nullptr, 0, nullptr, L};
    Source src = frame;
    src.mode = half ? Source::kOddPairs : kind;
    src.L = half ? R / 2 : R;
    src.window = rwin;
    src.gin = gin;
    Sink fwd{half ? Sink::kRaderHalf : Sink::kRaderForward, Bf, R, f2(bt), nullptr, R};
    fwd.a0 = a0;
    cudaError_t err = four_step(src, fwd, A, f2(rtab), R, fs1, nf, s);
    if (err != cudaSuccess) return (int)err;
    Source mid{half ? Source::kRaderSplit : Source::kBuffer, nullptr, 0, 0, 1, 0, 0, nullptr, Bf,
               R, nullptr, R};
    mid.bt = f2(bt);
    mid.tw = f2(rtab);
    mid.half = R / 2;
    const Sink plain{Sink::kPlain, Bf, R, nullptr, nullptr, R};
    err = four_step(mid, plain, A, f2(rtab), R, fs, nf, s);
    if (err != cudaSuccess) return (int)err;
    const long long grid = (long long)((nf + kEpiFrames - 1) / kEpiFrames) * n_btiles;
    if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    power_from_rader<<<(int)grid, kThreads, 0, s>>>(Bf, R, qout, a0, frame, f2(twiddle), out, T,
                                                     F, L, even, g0, nf, n_btiles);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// The split route: an n_fft whose complex length L (n_fft / 2 or n_fft)
// splits as L = P Q (split_of; ops/spectrogram.py::split_plan).  The Q
// columns of P points of each frame (an odd frame's real columns two as one
// complex column) go through Rader's convolution over M = P - 1 points
// (gin: M ints g^m mod P; chirp null) or the chirp-z transform over M points
// (chirp: P pairs c_j; gin null; chirp_size_takes(P, P, M), M <=
// kOneBlockPoints), bt and ftab M pairs FFT(b) / M and e^{-2 pi i j / M}
// (ops/spectrogram.py::split_tables), col_tile columns a block in col_smem
// bytes (ops/spectrogram.py::split_column_plan: two tile buffers of M
// points, and 16 bytes a column for Rader), each column's outputs times the
// twiddle e^{-2 pi i n2 k1 / L} from `twiddle`; then the rows' Q-point
// transforms (P rows, or an odd frame's (P + 1) / 2), then the power.  scratch:
// scratch_bytes of device memory, at least two chunk buffers of S points a
// frame of chunk_frames(S, B T), S = L, or ((P + 1) / 2) Q for an odd
// n_fft (ops/spectrogram.py::split_scratch_bytes).  Three launches a chunk.
extern "C" int apt_spectrogram_power_split(const float* x, const float* window,
                                           const float* twiddle, const int* gin,
                                           const float* chirp, const float* bt, const float* ftab,
                                           float* out, int B, int N, int T, int n_fft, int hop,
                                           int pad, int M, int col_tile, int col_smem,
                                           float* scratch, long long scratch_bytes,
                                           void* stream) {
  const bool even = n_fft % 2 == 0;
  const int L = even ? n_fft / 2 : n_fft;
  if (n_fft < 1 || hop < 1 || B <= 0 || T <= 0 || N < 0 || pad < 0 || scratch == nullptr ||
      bt == nullptr || ftab == nullptr || !pow2_tile(col_tile))
    return (int)cudaErrorInvalidValue;
  const Split sp = split_of(L);
  if (!sp.ok || (sp.rader ? gin == nullptr || M != sp.P - 1
                          : chirp == nullptr || M > kOneBlockPoints ||
                                !chirp_size_takes(sp.P, sp.P, M)))
    return (int)cudaErrorInvalidValue;
  const long long smem = 16LL * tile_elems(M, col_tile) + (sp.rader ? 16LL * col_tile : 0);
  const int rows = even ? sp.P : (sp.P + 1) / 2;  // the rows kept
  FourStep fs;
  fs.N = rows * sp.Q;  // a frame's points in the chunk buffers
  fs.N1 = rows;
  fs.N2 = sp.Q;
  fs.row = split_row_step(sp.Q);
  const long long frames = (long long)B * T;
  const long long chunk = chunk_frames(fs.N, frames);
  if (smem != col_smem || smem > kSmemLimit || fs.row.lg < 0 ||
      16LL * fs.N * chunk > scratch_bytes)
    return (int)cudaErrorInvalidValue;
  const MixedPlan cplan = mixed_plan_of(M);
  int lg = 0;
  while ((1 << lg) < col_tile) ++lg;
  auto f2 = [](const float* p) { return reinterpret_cast<const float2*>(p); };
  float2* const A = reinterpret_cast<float2*>(scratch);
  float2* const Bf = A + chunk * fs.N;
  const cudaStream_t s = (cudaStream_t)stream;
  const int F = n_fft / 2 + 1, n_btiles = (F + kEpiBins - 1) / kEpiBins;
  for (long long g0 = 0; g0 < frames; g0 += chunk) {
    const int nf = (int)(frames - g0 < chunk ? frames - g0 : chunk);
    const Source frame{even ? Source::kEvenFrame : Source::kOddFrame, x, N, g0, T, hop, pad,
                       window, nullptr, 0, nullptr, L};
    const Column col{frame, sp.P, sp.Q, !even, sp.rader ? gin : nullptr,
                     sp.rader ? nullptr : f2(chirp)};
    const int n_cols = nf * (even ? sp.Q : (sp.Q + 1) / 2);
    cudaError_t err;
    if (sp.rader) {
      err = by_width(cplan, [&](auto w) {
        return launch_split_columns<decltype(w)::value, true>(
            col, A, f2(ftab), f2(bt), f2(twiddle), n_fft, M, lg, (int)smem, n_cols, cplan, s);
      });
    } else {
      err = launch_split_columns<7, false>(col, A, f2(ftab), f2(bt), f2(twiddle), n_fft, M, lg,
                                           (int)smem, n_cols, cplan, s);
    }
    if (err != cudaSuccess) return (int)err;
    const Sink snk{Sink::kPlain, Bf, fs.N, nullptr, nullptr, fs.N};
    err = by_width(fs.row.plan, [&](auto w) {
      return launch_rows<decltype(w)::value>(A, snk, f2(twiddle), n_fft, fs, nf, s);
    });
    if (err != cudaSuccess) return (int)err;
    const long long grid = (long long)((nf + kEpiFrames - 1) / kEpiFrames) * n_btiles;
    if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    if (even) {
      power_from_spectrum<<<(int)grid, kThreads, 0, s>>>(Bf, L, f2(twiddle), out, T, F, L, true,
                                                          g0, nf, n_btiles);
    } else {
      power_from_half_rows<<<(int)grid, kThreads, 0, s>>>(Bf, fs.N, out, T, F, sp.P, sp.Q, g0, nf,
                                                           n_btiles);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
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
