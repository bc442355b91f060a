// K2 and K3: the two per-frame tracker recurrences of the detector path,
// hand-written for Hopper (sm_90a).
//
// K2 replaces the `lax.scan` of `noise_psd_track`
// (audio_processing_tools_tpu/ops/trackers.py:121-201, step at :160-196);
// K3 replaces the `lax.scan` of `causal_low_quantile_baseline` (:30-82,
// step at :65-73, epilogue at :77-81).  Neither was a Pallas kernel: XLA
// compiled each scan into one time-major loop on the TPU, which read one
// contiguous vector of all lanes per step.  Eager PyTorch has no compiled
// scan, so written as tensor code each of the T = 873 steps would launch a
// dozen or more tiny kernels.
//
// What bounds them on this card.  Neither recurrence splits over T: the
// sign of each update depends on the carry.  So a kernel takes at least the
// larger of two times:
//  * the bytes, each read and written once, at 3.35 TB/s: K2 at the main
//    shape (128 clips x 71 band bins = 9,088 lanes, T = 873) reads 31.7 MB
//    of power and 0.11 MB of rain mask and writes 31.7 MB, 19 us; K3 (768
//    rows of T = 873) reads and writes 2.7 MB each, 1.6 us;
//  * the serial chain of one lane, 873 steps: K2's tracker chain (err ->
//    scale -> max -> step -> delta -> max -> select) is 9 dependent
//    instructions, K3's 8, ~16 and ~14 us at 4 cycles each and 1.98 GHz.
//    On the H100 a step took ~136 cycles in K2 and ~67 in K3 (each kernel's
//    time over its 873 steps), so the chain, and not the bytes, sets both
//    kernels' times.
//
// Design.  The public layout stays (lanes, T), T fastest, as the port's
// tensors are; coalescing is recovered inside the kernel.
//  * Few lanes per block, so that the grid covers the card: the plan takes
//    the largest power of two up to 32 lanes per block that still gives 132
//    blocks (K2 at the main shape: 32 lanes, 284 blocks; K3: 4 rows, 192
//    blocks).  A block has 128 threads: warp 0 walks (one lane a thread),
//    warps 1-3 load and store.  (One warp doing all three was slower: its
//    copy loops then sit between the walks.)
//  * Memory out of the chain: T is cut into tiles of 64 frames.  The loaders
//    copy the tile (lanes x 64 frames) with 4-byte cp.async, consecutive
//    threads on consecutive frames of one row (rows are 873 floats, not
//    16-byte aligned, so TMA and 16-byte copies cannot take them), into
//    shared rows padded to 65 floats so the walkers, one row each, hit 32
//    distinct banks.  Tile i+1 is in flight while the walkers step through
//    tile i; the walkers write their outputs to a shared output tile, which
//    the loaders store coalesced along T during the next tile's walk.  One
//    barrier per tile.  K2's rain mask is staged beside its tile as the
//    aligned words that hold each clip's bytes, one row per clip of the
//    block (lanes of one clip read one address, a broadcast).
//  * A walker reads 8 frames at a time from shared memory into registers,
//    the next 8 while it steps these, through __restrict__ pointers, so no
//    shared-memory latency sits in the chain either.
//  * K2 reads its input in place through a clip stride and a row stride, so
//    the engine's band view P[:, rows, :] needs no copy first, and its bool
//    rain mask is read as bytes, without a cast.
//  * The launch plan (lanes per block, tile, threads, shared bytes, grid,
//    tiles) is computed in ops/trackers.py::tracker_launch_plan; the
//    launchers below refuse a plan unlike their own.
//
// Carries.  Each launcher takes optional carry-in and carry-out pointers:
// the streaming detector threads the trackers' state from one chunk of a live
// stream to the next (noise_psd_track_chunk, trackers.py:372-385, and
// causal_low_quantile_baseline_chunk, :262-302).  Null carry-in pointers give
// the offline start (the state built from frame 0); null carry-out pointers
// write no state.  Either way the walk is the same code, so a stream cut into
// chunks at any frame gives the bits of one call over the whole stream.  The
// launchers pick the instantiation by whether any carry pointer is given
// (the template flag kCarry), so the offline walk carries none of the
// streaming code in its registers.
//
// Arithmetic follows the plain PyTorch loops step for step: every product
// and sum is rounded on its own (__fmul_rn / __fadd_rn / __fsub_rn are never
// contracted into an FMA), constants arrive already rounded to float by the
// host exactly as the JAX program rounds them, and max/min propagate NaN as
// jnp.maximum/minimum do.  So the kernels give the plain loops' values, bit
// for bit wherever they are numbers (NaN payloads are not kept, see
// max_nan), and no value moves across a decision threshold.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The launch plan (mirrored by ops/trackers.py::tracker_launch_plan).
constexpr int kThreads = 128;                  // warp 0 walks, warps 1-3 load and store
constexpr int kWalkers = 32;
constexpr int kLoaders = kThreads - kWalkers;
constexpr int kMaxLanes = 32;                  // lanes per block, at most one walker warp
constexpr int kTargetBlocks = 132;             // one per SM of an H100
constexpr int kFrameTile = 64;                 // frames per staged tile
constexpr int kLgTile = 6;
constexpr int kPitch = kFrameTile + 1;         // floats per staged row: no bank conflicts
constexpr int kRainWords = kFrameTile / 4 + 1; // words per staged rain row: a tile's bytes
                                               // from a 4-byte aligned start; 17, odd, so
                                               // rows of different clips hit distinct banks
constexpr int kSmemLimit = 232448;
static_assert((1 << kLgTile) == kFrameTile, "tile");
static_assert(kThreads % 32 == 0 && kLoaders >= 32, "one walker warp and whole loader warps");

int lanes_per_block_for(long long lanes) {
  int L = kMaxLanes;
  while (L > 1 && (lanes + L - 1) / L < kTargetBlocks) L /= 2;
  return L;
}

// two input and two output tiles of L rows, and for K2 two rain tiles of up
// to L clips
size_t smem_bytes_for(int L, bool rain) {
  return 16 * (size_t)L * kPitch + (rain ? 8 * (size_t)L * kRainWords : 0);
}

bool plan_matches(long long lanes, int T, bool rain, int lanes_per_block, int frame_tile,
                  int threads, int smem_bytes, int grid, int n_tiles) {
  const int L = lanes_per_block_for(lanes);
  const size_t smem = smem_bytes_for(L, rain);
  return lanes_per_block == L && frame_tile == kFrameTile && threads == kThreads &&
         (size_t)smem_bytes == smem && smem <= (size_t)kSmemLimit &&
         (long long)grid == (lanes + L - 1) / L &&
         n_tiles == (int)(((long long)T + kFrameTile - 1) / kFrameTile);
}

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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// nan_max(a, floor) as one max.NaN instruction instead of two compares and
// a select, for a carry value against a floor where no signed-zero tie can
// arise (floor > 0, or a value that is never -0).  The value is nan_max's;
// a NaN comes out as the canonical NaN, where nan_max would pass the NaN it
// was given.  NaN payloads are not kept by any build of this code anyway:
// nvcc itself compiles the nan_max pattern to max.NaN where it can.
__device__ __forceinline__ float max_nan(float a, float floor) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(floor));
  return d;
}

// K2's carry (trackers.py:305-316): tracker, scale and the last output per
// lane; the warm-up count, the rain EMA and whether the stream has seen no
// frame yet per clip.
struct PsdCarry {
  const float *tracker, *scale, *prev_n;
  const int* wcount;
  const float* rain_ema;
  const uint8_t* is_first;
  float *o_tracker, *o_scale, *o_prev_n;
  int* o_wcount;
  float* o_rain_ema;
};

struct PsdConsts {
  float eta, scale_alpha, one_minus_scale_alpha, step_floor;
  int warmup_need;
  float q, neg_one_minus_q;
  int adaptive;
  float aq_min, q_minus_aq_min, ema_up, ema_down, maxr;
  float aq_alpha, one_minus_aq_alpha;
};

constexpr int kBatch = 8;  // frames a walker holds in registers at a time
static_assert(kFrameTile % kBatch == 0, "batches tile the frame tile");

// Walk frames 0 .. nt-1 of one staged row: the inputs of kBatch frames are
// read from shared memory into registers (the next batch while this one is
// stepped), so no shared-memory latency sits in the carry chain, and
// `step(j, x_j, rain_j)` advances the carry by frame j and returns its
// output.  `rain` is the row's staged rain words, whose byte `shift` is
// frame 0, or null.  The pointers are __restrict__: were the output row
// thought to alias the input row, no load could pass a store, and each step
// would wait for shared memory.
__device__ __forceinline__ uint32_t rain_byte(const uint32_t (&words)[2], int u) {
  return (words[u / 4] >> (8 * (u % 4))) & 0xffu;  // little-endian bytes
}

// bytes j0 .. j0 + 7 of a rain row as two words
__device__ __forceinline__ void rain_batch(const uint32_t* __restrict__ rain, int shift, int j0,
                                           uint32_t (&out)[2]) {
  const uint32_t* w = rain + j0 / 4;
  const uint32_t w0 = w[0], w1 = w[1], w2 = w[2];
  out[0] = __funnelshift_r(w0, w1, 8 * shift);
  out[1] = __funnelshift_r(w1, w2, 8 * shift);
}

template <class Step>
__device__ __forceinline__ void walk_row(const float* __restrict__ x,
                                         const uint32_t* __restrict__ rain, int shift,
                                         float* __restrict__ y, int nt, Step step) {
  static_assert(kBatch == 8, "a batch's rain bytes are two words");
  float xs[kBatch];
  uint32_t rs[2] = {};
#pragma unroll
  for (int u = 0; u < kBatch; ++u) xs[u] = x[u];
  if (rain) rain_batch(rain, shift, 0, rs);
  for (int j0 = 0; j0 < nt; j0 += kBatch) {
    float xn[kBatch] = {};
    uint32_t rn[2] = {};
    if (j0 + kBatch < nt) {  // inside the row: the prefetch never leaves the tile
#pragma unroll
      for (int u = 0; u < kBatch; ++u) xn[u] = x[j0 + kBatch + u];
      if (rain) rain_batch(rain, shift, j0 + kBatch, rn);
    }
    if (j0 + kBatch <= nt) {
#pragma unroll
      for (int u = 0; u < kBatch; ++u) y[j0 + u] = step(j0 + u, xs[u], rain_byte(rs, u));
    } else {
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (j0 + u < nt) y[j0 + u] = step(j0 + u, xs[u], rain_byte(rs, u));
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) xs[u] = xn[u];
    rs[0] = rn[0];
    rs[1] = rn[1];
  }
}

// K2's step (trackers.py:160-196) with its 5-value carry (:148-155).
//
// One frame's chain runs tracker -> err -> scale -> step -> delta ->
// tracker, and beside it prev_n -> lam -> n -> prev_n.  It is written short,
// with the plain loop's values: the sign test picks the multiplier of the
// step before the one product (q * step and step * q round alike), 1 - lam
// is computed once for both rates, and the two maxes of the tracker's chain
// are single max.NaN instructions (see max_nan).
template <bool kCarry>
struct PsdTracker {
  static constexpr bool kRain = true;
  PsdConsts c;
  PsdCarry io;
  float tracker, scale, prev_n, rain_ema;
  int wcount;
  int lane, clip;
  bool lead;   // the clip's first lane writes its per-clip carry
  bool first;  // frame 0 of this call is the stream's first frame

  template <bool kAdaptive>
  __device__ __forceinline__ void walk_q(const float* x, const uint32_t* rain, int shift,
                                         float* y, int t0, int nt) {
    // the carry in locals, so that the step's closure keeps it in registers
    float tracker = this->tracker, scale = this->scale, prev_n = this->prev_n;
    float rain_ema = this->rain_ema;
    int wcount = this->wcount;
    const PsdConsts c = this->c;
    const bool first = kCarry ? this->first : true;
    // 1 - lam of both EMA rates, rounded as the loop rounds __fsub_rn(1, lam)
    const float one_minus_up = __fsub_rn(1.f, c.ema_up);
    const float one_minus_down = __fsub_rn(1.f, c.ema_down);
    walk_row(x, rain, shift, y, nt, [&](int j, float pt, uint32_t rain_j) {
      const bool f = first && t0 + j == 0;
      const bool raint = rain_j != 0;
      const bool allow = (wcount < c.warmup_need) || !raint;

      const float err = __fsub_rn(pt, tracker);
      const float scale_new = __fadd_rn(__fmul_rn(c.scale_alpha, scale),
                                        __fmul_rn(c.one_minus_scale_alpha, fabsf(err)));
      const float step = __fmul_rn(c.eta, max_nan(scale_new, c.step_floor));
      float up = c.q, down = c.neg_one_minus_q;
      if constexpr (kAdaptive) {
        float q_eff = __fsub_rn(c.q, __fmul_rn(c.q_minus_aq_min, rain_ema));
        q_eff = nan_min(nan_max(q_eff, c.aq_min), c.q);
        up = q_eff;
        down = -__fsub_rn(1.f, q_eff);
      }
      const float delta = __fmul_rn((pt >= tracker) ? up : down, step);
      // tracker >= +0 and delta != -0, so the sum is never -0
      const float candidate = max_nan(__fadd_rn(tracker, delta), 0.f);
      // the stream's first frame keeps the initial tracker and scale
      const float tracker_new = (f || !allow) ? tracker : candidate;
      const float scale_out = f ? scale : scale_new;

      const bool rising = tracker_new > prev_n;
      const float n_ema = __fadd_rn(__fmul_rn(rising ? c.ema_up : c.ema_down, prev_n),
                                    __fmul_rn(rising ? one_minus_up : one_minus_down,
                                              tracker_new));
      float n = f ? tracker_new : n_ema;
      n = nan_min(n, __fmul_rn(c.maxr, pt));
      n = nan_max(n, 0.f);

      wcount += allow ? 1 : 0;
      rain_ema = __fadd_rn(__fmul_rn(c.aq_alpha, rain_ema),
                           __fmul_rn(c.one_minus_aq_alpha, raint ? 1.f : 0.f));
      tracker = tracker_new;
      scale = scale_out;
      prev_n = n;
      return n;
    });
    this->tracker = tracker;
    this->scale = scale;
    this->prev_n = prev_n;
    this->rain_ema = rain_ema;
    this->wcount = wcount;
  }

  // frames t0 .. t0 + nt - 1 of one lane, from shared rows x and rain to y
  __device__ __forceinline__ void walk(const float* x, const uint32_t* rain, int shift, float* y,
                                       int t0, int nt) {
    if (t0 == 0) {
      if (kCarry && io.tracker) {
        tracker = io.tracker[lane];
        scale = io.scale[lane];
        prev_n = io.prev_n[lane];
        wcount = io.wcount[clip];
        rain_ema = io.rain_ema[clip];
        first = io.is_first[clip] != 0;
      } else {
        const float x0 = x[0];
        tracker = nan_max(x0, 0.f);
        scale = nan_max(fabsf(x0), c.step_floor);
        prev_n = 0.f;
        wcount = 0;
        rain_ema = 0.f;
        first = true;
      }
    }
    if (c.adaptive) {
      walk_q<true>(x, rain, shift, y, t0, nt);
    } else {
      walk_q<false>(x, rain, shift, y, t0, nt);
    }
  }

  __device__ __forceinline__ void bind(int g, int K) {
    lane = g;
    clip = g / K;
    lead = g - clip * K == 0;
  }

  __device__ __forceinline__ void finish() const {
    if (!kCarry || !io.o_tracker) return;
    io.o_tracker[lane] = tracker;
    io.o_scale[lane] = scale;
    io.o_prev_n[lane] = prev_n;
    if (lead) {
      io.o_wcount[clip] = wcount;
      io.o_rain_ema[clip] = rain_ema;
    }
  }
};

struct BaselineConsts {
  float q, neg_one_minus_q, eta, scale_alpha, one_minus_scale_alpha, floor;
};

// K3's carry (trackers.py:256-259): the baseline and scale per row.
struct BaselineCarry {
  const float *baseline, *scale;
  float *o_baseline, *o_scale;
};

// K3's step (trackers.py:65-73): emit before ingesting x[t], with the
// nan_to_num / floor epilogue (:77-79) applied at the emit.
template <bool kCarry>
struct BaselineTracker {
  static constexpr bool kRain = false;
  BaselineConsts c;
  BaselineCarry io;
  float baseline, scale;
  int lane;

  __device__ __forceinline__ void walk(const float* x, const uint32_t*, int, float* y, int t0,
                                       int nt) {
    if (t0 == 0) {
      if (kCarry && io.baseline) {
        baseline = io.baseline[lane];
        scale = io.scale[lane];
      } else {
        const float x0 = x[0];
        baseline = nan_max(x0, c.floor);
        scale = nan_max(fabsf(x0), c.floor);
      }
    }
    float baseline = this->baseline, scale = this->scale;
    const BaselineConsts c = this->c;
    walk_row(x, nullptr, 0, y, nt, [&](int, float xt, uint32_t) {
      const float e = isfinite(baseline) ? baseline : c.floor;
      const float emitted = nan_max(e, c.floor);

      const float err = __fsub_rn(xt, baseline);
      scale = __fadd_rn(__fmul_rn(c.scale_alpha, scale),
                        __fmul_rn(c.one_minus_scale_alpha, fabsf(err)));
      const float step = __fmul_rn(c.eta, max_nan(scale, c.floor));
      const float delta = __fmul_rn((xt >= baseline) ? c.q : c.neg_one_minus_q, step);
      baseline = max_nan(__fadd_rn(baseline, delta), c.floor);
      return emitted;
    });
    this->baseline = baseline;
    this->scale = scale;
  }

  __device__ __forceinline__ void bind(int g, int) { lane = g; }

  __device__ __forceinline__ void finish() const {
    if (!kCarry || !io.o_baseline) return;
    io.o_baseline[lane] = baseline;
    io.o_scale[lane] = scale;
  }
};

// Where the lanes live.  Lane g is row (g / K, g % K) of the input, which
// starts at x + (g / K) * clip_stride + (g % K) * row_stride with its T
// frames contiguous; its output row is out + g * T; its rain row (K2) is
// rain + (g / K) * T.
struct Rows {
  const float* x;
  long long clip_stride, row_stride;
  int K;
  const uint8_t* rain;
  float* out;
  int lanes, T, lanes_per_block, n_tiles;
};

template <class Tracker>
__global__ void __launch_bounds__(kThreads) tracker_tiles(Rows r, Tracker trk) {
  extern __shared__ float4 smem4[];
  __shared__ long long row_off[kMaxLanes];
  const int L = r.lanes_per_block;
  float* const xin = reinterpret_cast<float*>(smem4);  // [2][L][kPitch]
  float* const yout = xin + 2 * L * kPitch;           // [2][L][kPitch]
  uint32_t* const rin = reinterpret_cast<uint32_t*>(yout + 2 * L * kPitch);  // [2][L][kRainWords]

  const int lane0 = blockIdx.x * L;
  const int nl = min(L, r.lanes - lane0);
  const int clip0 = lane0 / r.K;
  const int nclips = (lane0 + nl - 1) / r.K - clip0 + 1;  // <= nl
  if (threadIdx.x < nl) {
    const int g = lane0 + threadIdx.x, b = g / r.K;
    row_off[threadIdx.x] = b * r.clip_stride + (long long)(g - b * r.K) * r.row_stride;
  }
  __syncthreads();

  const int ld = (int)threadIdx.x - kWalkers;  // loader index, < 0 for walkers

  // loaders: start copying tile `tile` into buffer `buf`
  auto load = [&](int tile, int buf) {
    const int t0 = tile * kFrameTile, nt = min(kFrameTile, r.T - t0);
    float* const dst = xin + buf * L * kPitch;
    for (int i = ld; i < nl * kFrameTile; i += kLoaders) {
      const int l = i >> kLgTile, j = i & (kFrameTile - 1);
      if (j < nt) cp_async4(dst + l * kPitch + j, r.x + row_off[l] + t0 + j);
    }
    if constexpr (Tracker::kRain) {
      // each clip's bytes t0 .. t0 + nt - 1 as the aligned words that hold
      // them (an allocation holds whole aligned words)
      uint32_t* const rdst = rin + buf * L * kRainWords;
      for (int i = ld; i < nclips * kRainWords; i += kLoaders) {
        const int c = i / kRainWords, k = i - c * kRainWords;
        const uintptr_t first = reinterpret_cast<uintptr_t>(r.rain) +
                                (uintptr_t)(clip0 + c) * r.T + t0;
        if (4 * k < (int)(first & 3) + nt)
          cp_async4(rdst + i, reinterpret_cast<const uint32_t*>((first & ~(uintptr_t)3) + 4 * k));
      }
    }
  };
  // loaders: store the outputs of tile `tile` from buffer `buf`
  auto store = [&](int tile, int buf) {
    const int t0 = tile * kFrameTile, nt = min(kFrameTile, r.T - t0);
    const float* const src = yout + buf * L * kPitch;
    for (int i = ld; i < nl * kFrameTile; i += kLoaders) {
      const int l = i >> kLgTile, j = i & (kFrameTile - 1);
      if (j < nt) r.out[(long long)(lane0 + l) * r.T + t0 + j] = src[l * kPitch + j];
    }
  };

  Tracker w = trk;
  const int l = threadIdx.x;
  if (ld < 0 && l < nl) w.bind(lane0 + l, r.K);
  // walkers: this lane's row among the staged rain rows, and the byte of
  // that row which holds frame t0 of every tile (tiles start at multiples of 4)
  const int rain_row = (lane0 + l) / r.K - clip0;
  const int shift = Tracker::kRain
      ? (int)((reinterpret_cast<uintptr_t>(r.rain) + (uintptr_t)(clip0 + rain_row) * r.T) & 3)
      : 0;
  if (ld >= 0) {
    load(0, 0);
    cp_async_wait_all();
  }
  for (int tile = 0; tile < r.n_tiles; ++tile) {
    __syncthreads();  // tile `tile` has landed; the buffers of tile - 1 are free
    const int buf = tile & 1;
    if (ld < 0) {
      if (l < nl) {
        const int t0 = tile * kFrameTile;
        w.walk(xin + (buf * L + l) * kPitch, rin + (buf * L + rain_row) * kRainWords, shift,
               yout + (buf * L + l) * kPitch, t0, min(kFrameTile, r.T - t0));
      }
    } else {
      if (tile + 1 < r.n_tiles) load(tile + 1, buf ^ 1);
      if (tile > 0) store(tile - 1, buf ^ 1);
      cp_async_wait_all();
    }
  }
  __syncthreads();
  if (ld >= 0) {
    store(r.n_tiles - 1, (r.n_tiles - 1) & 1);
  } else if (l < nl) {
    w.finish();
  }
}

template <class Tracker>
cudaError_t launch(const Rows& r, const Tracker& trk, int grid, size_t smem,
                   cudaStream_t stream) {
  // dynamic shared bytes above 48 KB already allowed, per device
  static size_t allowed[64] = {};
  auto kernel = tracker_tiles<Tracker>;
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
  kernel<<<grid, kThreads, smem, stream>>>(r, trk);
  return cudaGetLastError();
}

}  // namespace

// P: (B, K, T) power with frames contiguous, clip and row strides in floats
// (the engine's band view of the spectrogram goes in as it is); rain: (B, T)
// bytes; out: (B, K, T) contiguous.  The plan is that of
// ops/trackers.py::tracker_launch_plan, which must equal this file's own.
// Carry in (all null, or none): tracker, scale, prev_n (B, K); wcount (B,)
// int32, rain_ema (B,), is_first (B,) bytes.  Carry out (all null, or none):
// the same but is_first, after frame T - 1.
extern "C" int apt_noise_psd_track(
    const float* P, const uint8_t* rain, float* out, int B, int K, int T,
    long long clip_stride, long long row_stride, int lanes_per_block, int frame_tile,
    int threads, int smem_bytes, int grid, int n_tiles, float eta, float scale_alpha,
    float one_minus_scale_alpha, float step_floor, int warmup_need, float q,
    float neg_one_minus_q, int adaptive, float aq_min, float q_minus_aq_min, float ema_up,
    float ema_down, float maxr, float aq_alpha, float one_minus_aq_alpha, const float* c_tracker,
    const float* c_scale, const float* c_prev_n, const int* c_wcount, const float* c_rain_ema,
    const uint8_t* c_is_first, float* o_tracker, float* o_scale, float* o_prev_n, int* o_wcount,
    float* o_rain_ema, void* stream) {
  const long long lanes = (long long)B * K;
  if (B <= 0 || K <= 0 || T <= 0 || lanes > 0x7fffffffLL || clip_stride < 0 || row_stride < 0)
    return (int)cudaErrorInvalidValue;
  if (!plan_matches(lanes, T, true, lanes_per_block, frame_tile, threads, smem_bytes, grid,
                    n_tiles))
    return (int)cudaErrorInvalidValue;
  const bool in_any = c_tracker || c_scale || c_prev_n || c_wcount || c_rain_ema || c_is_first;
  const bool in_all = c_tracker && c_scale && c_prev_n && c_wcount && c_rain_ema && c_is_first;
  const bool out_any = o_tracker || o_scale || o_prev_n || o_wcount || o_rain_ema;
  const bool out_all = o_tracker && o_scale && o_prev_n && o_wcount && o_rain_ema;
  if (in_any != in_all || out_any != out_all) return (int)cudaErrorInvalidValue;
  const PsdCarry io{c_tracker, c_scale, c_prev_n, c_wcount, c_rain_ema, c_is_first,
                    o_tracker, o_scale, o_prev_n, o_wcount, o_rain_ema};
  const PsdConsts c{eta, scale_alpha, one_minus_scale_alpha, step_floor, warmup_need, q,
                    neg_one_minus_q, adaptive, aq_min, q_minus_aq_min, ema_up, ema_down, maxr,
                    aq_alpha, one_minus_aq_alpha};
  const Rows r{P, clip_stride, row_stride, K, rain, out, (int)lanes, T, lanes_per_block,
               n_tiles};
  if (in_any || out_any) {
    PsdTracker<true> trk{};
    trk.io = io;
    trk.c = c;
    return (int)launch(r, trk, grid, (size_t)smem_bytes, (cudaStream_t)stream);
  }
  PsdTracker<false> trk{};
  trk.c = c;
  return (int)launch(r, trk, grid, (size_t)smem_bytes, (cudaStream_t)stream);
}

// x, out: (R, T) contiguous.  Carry in and out (each both null, or none):
// baseline and scale (R,).
extern "C" int apt_causal_low_quantile_baseline(
    const float* x, float* out, int R, int T, int lanes_per_block, int frame_tile, int threads,
    int smem_bytes, int grid, int n_tiles, float q, float neg_one_minus_q, float eta,
    float scale_alpha, float one_minus_scale_alpha, float floor, const float* c_baseline,
    const float* c_scale, float* o_baseline, float* o_scale, void* stream) {
  if (R <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  if (!c_baseline != !c_scale || !o_baseline != !o_scale) return (int)cudaErrorInvalidValue;
  if (!plan_matches(R, T, false, lanes_per_block, frame_tile, threads, smem_bytes, grid,
                    n_tiles))
    return (int)cudaErrorInvalidValue;
  const BaselineConsts c{q, neg_one_minus_q, eta, scale_alpha, one_minus_scale_alpha, floor};
  const Rows r{x, (long long)T, 0, 1, nullptr, out, R, T, lanes_per_block, n_tiles};
  if (c_baseline || o_baseline) {
    BaselineTracker<true> trk{};
    trk.io = BaselineCarry{c_baseline, c_scale, o_baseline, o_scale};
    trk.c = c;
    return (int)launch(r, trk, grid, (size_t)smem_bytes, (cudaStream_t)stream);
  }
  BaselineTracker<false> trk{};
  trk.c = c;
  return (int)launch(r, trk, grid, (size_t)smem_bytes, (cudaStream_t)stream);
}
