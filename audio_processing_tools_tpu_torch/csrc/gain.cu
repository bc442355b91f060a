// K5: the suppressor's per-frame temporal gain smoothing, hand-written for
// Hopper (sm_90a).
//
// Replaces the `lax.scan` of `compute_gain` over `gain_time_step`
// (audio_processing_tools_tpu/models/spectral_noise.py:127-178): starting
// from G_0 = G_freq[..., 0], each frame t >= 1 takes
//
//   adaptive:      alpha_t = nc_t < 0.7 ? 0 : alpha_base * (nc_t - 0.7) / denom
//                  G_t = alpha_t * G_{t-1} + (1 - alpha_t) * G_freq[t]
//                  G_t = max(G_t, G_freq[t]) where nc_t < 0.7
//   non-adaptive:  G_t = alpha_base * G_{t-1} + (1 - alpha_base) * G_freq[t]
//
// and every output is clipped to [gain_floor, gain_ceil].  It was not a
// Pallas kernel: XLA compiled the scan into one loop on the TPU.  Eager
// PyTorch has no compiled scan, so as tensor code each of the T = 873 steps
// would launch several tiny kernels.
//
// What bounds it on this card: bytes.  At the suppressor's shape (128 clips
// x 71 band bins = 9,088 lanes, T = 873) G_freq is 31.7 MB read and as much
// written, with 0.4 MB of noise_conf: 19 us at 3.35 TB/s.  A lane's chain
// (a product, a sum, and on a rain frame a compare and a select) is ~12-20
// cycles a step, 5-9 us over 873 steps at 1.98 GHz.
//
// Design: staged tiles, as K2 (csrc/trackers.cu), deep enough to keep the
// bytes in flight that the bandwidth needs.
//  * Up to kMaxLanes lanes a block, in a multiple of kTargetBlocks blocks
//    of even size (23 lanes, 396 blocks at the suppressor's shape: three an
//    SM, where K2's rule of the largest power of two gives 284 blocks of 32,
//    two or three an SM).  A block has 128 threads: warp 0 walks (one lane
//    a thread), warps 1-3 load and store, a warp a row at a time.
//  * T is cut into tiles of kFrameTile frames.  The loaders copy a tile
//    (lanes x frames, and the noise_conf rows of the block's clips) with
//    4-byte cp.async, a loader warp a row at a time, its lanes on
//    consecutive frames (rows of 873 floats are not 16-byte aligned), into
//    shared rows padded to kFrameTile + 1 floats, so the walkers, a row
//    each, hit distinct banks.  A ring of kStages tiles: kStages - 1 are in
//    flight while the walkers step through one, one cp.async group a tile,
//    one barrier a tile.
//  * Adaptive: at the start of a tile the walker warp computes alpha once a
//    (clip, frame) of the tile into a shared row (the division leaves the
//    lanes' chains), then each lane steps its row out of registers, 8 frames
//    read ahead from shared memory.
//  * Outputs go to a shared tile, which the loaders store coalesced along T
//    during the next tile's walk.
//
// Arithmetic follows the plain PyTorch loop step for step: every product,
// sum and quotient is rounded on its own (__fmul_rn / __fadd_rn / __fdiv_rn
// are never contracted into an FMA), the constants arrive rounded to float
// by the host as the JAX program rounds them (0.7, denom and alpha_base to
// float32, `1 - alpha_t` in float32, but `1 - alpha_base` in double and then
// rounded), and max/min propagate NaN as jnp.maximum/minimum do.  So the
// kernel gives the plain loop's bits wherever they are numbers (nvcc's
// max.NaN does not keep NaN payloads).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;         // warp 0 walks, warps 1-3 load and store
constexpr int kWalkers = 32;
constexpr int kLoaderWarps = (kThreads - kWalkers) / 32;
constexpr int kMaxLanes = 32;         // lanes a block, at most one walker warp
constexpr int kTargetBlocks = 132;    // one per SM of an H100
constexpr int kFrameTile = 64;        // frames a staged tile
constexpr int kLgTile = 6;
constexpr int kStages = 4;            // tiles in the ring: kStages - 1 in flight
constexpr int kPitch = kFrameTile + 1;  // floats a staged row: no bank conflicts
constexpr int kBatch = 8;             // frames a walker holds in registers at a time
constexpr int kSmemLimit = 232448;
static_assert((1 << kLgTile) == kFrameTile, "tile");
static_assert(kStages >= 2 && kStages <= 8, "the ring");
static_assert(kMaxLanes <= kWalkers, "one walker warp");
static_assert(kThreads % 32 == 0 && kLoaderWarps >= 1, "one walker warp and whole loader warps");
static_assert(kFrameTile >= 32, "a tile's row spans a loader warp's lanes");

// jnp.maximum / jnp.minimum: NaN in either operand gives NaN
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || a < b) ? a : b;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct GainConsts {
  float th, denom, alpha_base, one_minus_alpha_base, floor, ceil;
};

__device__ __forceinline__ float clip(float g, const GainConsts& c) {
  return nan_min(nan_max(g, c.floor), c.ceil);
}

// lanes a block: the fewest blocks a multiple of kTargetBlocks can hold at
// kMaxLanes a block, shared evenly (9,088 lanes: 396 blocks of 23), so
// every SM gets as many lanes
int lanes_per_block_for(long long lanes) {
  const long long per_sm = (lanes + (long long)kMaxLanes * kTargetBlocks - 1) /
                           ((long long)kMaxLanes * kTargetBlocks);
  const long long L = (lanes + kTargetBlocks * per_sm - 1) / (kTargetBlocks * per_sm);
  return (int)(L < 1 ? 1 : L);
}

// clips a block of L consecutive lanes can touch, K lanes a clip
int clips_per_block_for(int L, int K) {
  const int n = (L + K - 2) / K + 1;
  return n < L ? n : L;
}

// the ring of input tiles and noise_conf rows, the alpha rows, two output
// tiles, and 2 kBatch floats past the end that a walker's read-ahead may touch
size_t smem_floats(int L, int NC, bool adaptive) {
  return (size_t)kPitch * (kStages * L + 2 * L + (adaptive ? (kStages + 1) * NC : 0)) +
         2 * kBatch;
}

// Frames j .. nt - 1 of one staged row: x the gain rows, y the outputs; for
// the adaptive step n the noise_conf row and a the alpha row of the lane's
// clip.  Each batch of kBatch frames is read into registers while the one
// before is stepped, so no shared-memory latency sits in the carry chain.
// The read-ahead runs up to 2 kBatch floats past a row's frames, into the
// next row or the padding after the last (values never used), so its
// addresses are the row's plus constants.
template <bool kAdaptive>
__device__ __forceinline__ float walk_row(const float* __restrict__ x, const float* __restrict__ n,
                                          const float* __restrict__ a, float* __restrict__ y,
                                          int j, int nt, float g, const GainConsts& c) {
  float xs[kBatch], ns[kBatch], as[kBatch];
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    xs[u] = x[j + u];
    if (kAdaptive) {
      ns[u] = n[j + u];
      as[u] = a[j + u];
    }
  }
  auto step = [&](int u) {
    const float gft = xs[u];
    float gt;
    if (kAdaptive) {
      const float alpha = as[u];
      gt = __fadd_rn(__fmul_rn(alpha, g), __fmul_rn(__fsub_rn(1.f, alpha), gft));
      // nan_max(gt, gft) on a rain frame.  gt is NaN wherever gft is (a NaN
      // operand makes a product and the sum NaN), so the max is gft exactly
      // where gt <= gft, and gt otherwise, NaN included: one ordered compare
      // on the carry's chain in place of nan_max's three
      if (ns[u] < c.th && gt <= gft) gt = gft;
    } else {
      gt = __fadd_rn(__fmul_rn(c.alpha_base, g), __fmul_rn(c.one_minus_alpha_base, gft));
    }
    g = gt;
    y[j + u] = clip(g, c);
  };
  for (; j < nt; j += kBatch) {
    float xn[kBatch], nn[kBatch], an[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {  // the next batch
      xn[u] = x[j + kBatch + u];
      if (kAdaptive) {
        nn[u] = n[j + kBatch + u];
        an[u] = a[j + kBatch + u];
      }
    }
    if (j + kBatch <= nt) {
#pragma unroll
      for (int u = 0; u < kBatch; ++u) step(u);
    } else {
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (j + u < nt) step(u);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      xs[u] = xn[u];
      if (kAdaptive) {
        ns[u] = nn[u];
        as[u] = an[u];
      }
    }
  }
  return g;
}

template <bool kAdaptive>
__global__ void __launch_bounds__(kThreads)
gain_time_smooth_kernel(const float* __restrict__ g_freq, const float* __restrict__ nc,
                        float* __restrict__ out, int lanes, int K, int T, int L, int NC,
                        int n_tiles, GainConsts c) {
  extern __shared__ float4 smem4[];
  float* const xin = reinterpret_cast<float*>(smem4);  // [kStages][L][kPitch]
  float* const yout = xin + kStages * L * kPitch;     // [2][L][kPitch]
  float* const ncin = yout + 2 * L * kPitch;          // [kStages][NC][kPitch]
  float* const arow = ncin + kStages * NC * kPitch;   // [NC][kPitch]

  const int lane0 = blockIdx.x * L;
  const int nl = min(L, lanes - lane0);
  const int clip0 = lane0 / K;
  const int nclips = (lane0 + nl - 1) / K - clip0 + 1;  // <= NC
  const int ld = (int)threadIdx.x - kWalkers;           // loader index, < 0 for walkers

  // loaders: a loader warp takes rows lw, lw + kLoaderWarps, ..., its lanes
  // the frames of a row, so a row's address is computed once a tile
  const int lw = ld >> 5, lane = threadIdx.x & 31;
  // loaders: start copying tile `tile` into ring slot `buf`, one group
  auto load = [&](int tile, int buf) {
    const int t0 = tile * kFrameTile, nt = min(kFrameTile, T - t0);
    for (int l = lw; l < nl; l += kLoaderWarps) {
      float* const dst = xin + (buf * L + l) * kPitch;
      const float* const src = g_freq + (size_t)(lane0 + l) * T + t0;
#pragma unroll
      for (int j = lane; j < kFrameTile; j += 32)
        if (j < nt) cp_async4(dst + j, src + j);
    }
    if (kAdaptive) {
      for (int r = lw; r < nclips; r += kLoaderWarps) {
        float* const dst = ncin + (buf * NC + r) * kPitch;
        const float* const src = nc + (size_t)(clip0 + r) * T + t0;
#pragma unroll
        for (int j = lane; j < kFrameTile; j += 32)
          if (j < nt) cp_async4(dst + j, src + j);
      }
    }
  };
  // loaders: store the outputs of tile `tile` from output buffer `buf`
  auto store = [&](int tile, int buf) {
    const int t0 = tile * kFrameTile, nt = min(kFrameTile, T - t0);
    for (int l = lw; l < nl; l += kLoaderWarps) {
      const float* const src = yout + (buf * L + l) * kPitch;
      float* const dst = out + (size_t)(lane0 + l) * T + t0;
#pragma unroll
      for (int j = lane; j < kFrameTile; j += 32)
        if (j < nt) dst[j] = src[j];
    }
  };

  const int l = threadIdx.x;  // a walker's lane of the block
  const bool walks = ld < 0 && l < nl;
  const int row = walks ? (lane0 + l) / K - clip0 : 0;  // the walker's clip row
  float g = 0.f;
  if (ld >= 0) {
#pragma unroll
    for (int k = 0; k < kStages - 1; ++k) {
      if (k < n_tiles) load(k, k);
      cp_async_commit();
    }
    cp_async_wait<kStages - 2>();
  }
  for (int tile = 0; tile < n_tiles; ++tile) {
    __syncthreads();  // tile `tile` has landed; its ring slot's predecessor is free
    const int buf = tile % kStages;
    const int t0 = tile * kFrameTile, nt = min(kFrameTile, T - t0);
    if (ld < 0) {
      const float* const n = ncin + buf * NC * kPitch;
      if (kAdaptive) {  // alpha once a (clip, frame) of the tile
        for (int i = threadIdx.x; i < nclips * kFrameTile; i += kWalkers) {
          const int r = i >> kLgTile, j = i & (kFrameTile - 1);
          if (j < nt) {
            const float nct = n[r * kPitch + j];
            arow[r * kPitch + j] =
                nct < c.th ? 0.f
                           : __fmul_rn(c.alpha_base, __fdiv_rn(__fsub_rn(nct, c.th), c.denom));
          }
        }
        __syncwarp();
      }
      if (walks) {
        const float* const x = xin + (buf * L + l) * kPitch;
        float* const y = yout + ((tile & 1) * L + l) * kPitch;
        int j = 0;
        if (tile == 0) {  // G_0 = G_freq[..., 0]
          g = x[0];
          y[0] = clip(g, c);
          j = 1;
        }
        g = walk_row<kAdaptive>(x, n + row * kPitch, arow + row * kPitch, y, j, nt, g, c);
      }
    } else {
      if (tile + kStages - 1 < n_tiles) load(tile + kStages - 1, (tile + kStages - 1) % kStages);
      cp_async_commit();
      if (tile > 0) store(tile - 1, (tile - 1) & 1);
      cp_async_wait<kStages - 2>();
    }
  }
  __syncthreads();
  if (ld >= 0) store(n_tiles - 1, (n_tiles - 1) & 1);
}

template <bool kAdaptive>
cudaError_t launch(const float* g_freq, const float* nc, float* out, int lanes, int K, int T,
                   const GainConsts& c, cudaStream_t stream) {
  // the lane plan, halved until its shared memory fits (a block of few
  // lanes a clip stages a noise_conf row for each)
  int L = lanes_per_block_for(lanes), NC = clips_per_block_for(L, K);
  while (L > 1 && smem_floats(L, NC, kAdaptive) * sizeof(float) > (size_t)kSmemLimit) {
    L = (L + 1) / 2;
    NC = clips_per_block_for(L, K);
  }
  const size_t smem = smem_floats(L, NC, kAdaptive) * sizeof(float);
  if (smem > (size_t)kSmemLimit) return cudaErrorInvalidValue;
  // dynamic shared bytes above 48 KB already allowed, per device
  static size_t allowed[64] = {};
  auto kernel = gain_time_smooth_kernel<kAdaptive>;
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= 64 || smem > allowed[dev]) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
      if (dev < 64) allowed[dev] = smem;
    }
  }
  const int grid = (lanes + L - 1) / L;
  const int n_tiles = (T + kFrameTile - 1) / kFrameTile;
  kernel<<<grid, kThreads, smem, stream>>>(g_freq, nc, out, lanes, K, T, L, NC, n_tiles, c);
  return cudaGetLastError();
}

}  // namespace

// g_freq, out: (B, K, T) contiguous; nc: (B, T) contiguous.
extern "C" int apt_gain_time_smooth(const float* g_freq, const float* nc,
                                    float* out, int B, int K, int T,
                                    int adaptive, float th, float denom,
                                    float alpha_base,
                                    float one_minus_alpha_base, float floor,
                                    float ceil, void* stream) {
  if (B <= 0 || K <= 0 || T <= 0 || (long long)B * K > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const GainConsts c{th, denom, alpha_base, one_minus_alpha_base, floor, ceil};
  const int lanes = B * K;
  return adaptive ? (int)launch<true>(g_freq, nc, out, lanes, K, T, c, (cudaStream_t)stream)
                  : (int)launch<false>(g_freq, nc, out, lanes, K, T, c, (cudaStream_t)stream);
}
