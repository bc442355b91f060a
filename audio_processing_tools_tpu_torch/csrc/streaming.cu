// K8: the streaming suppressor's per-frame scan, hand-written for Hopper
// (sm_90a).
//
// It replaces the `lax.scan` over `sup_step` in the streaming detector
// (audio_processing_tools_tpu/models/streaming.py:348-418), which the JAX
// package keeps un-unrolled and fenced by optimization barriers so that its
// float sequence does not depend on the chunk length.  For each frame of a
// chunk, in order, it runs
//
//   the suppressor's noise PSD step (trackers.py:319-369) with rain = the
//   frame is not noise, the lagged or seeded N, N_eff = min(N, maxr P);
//   the SNR gate (optional) from two sums over the SNR columns;
//   gain_freq_stage (spectral_noise.py:68-124): oversubtraction, the
//   sqrt-sub or Wiener gain, the clip and the frequency smoothing;
//   gain_time_step (:127-147), the stream's first frame taking G_f, the clip;
//   S_hat = S with the band rows scaled, a real inverse FFT, the window, the
//   carried half-frame of the overlap-add and the 1 / sum(w^2) factor,
//
// and carries (PSD tracker, G, overlap-add tail) from one chunk to the next.
//
// What bounds it on this card.  Bytes are small (64 streams x 2 s: 5.7 MB
// of samples and 3.2 MB of band power in, 5.7 MB of audio out, 4.4 us at
// 3.35 TB/s); the transforms are two real FFTs of n_fft points per frame,
// 0.05 GFLOP per chunk.  What cannot be spread is the chain of frames:
// frame t + 1's gain needs frame t's (the EMA) and its tracker frame t's
// tracker, a few hundred dependent instructions and a barrier per frame
// (on an H100 the walk takes ~0.6 us a frame).  But only the gain is on
// that chain: the forward spectrum of a frame depends on its samples alone,
// and its inverse on the spectrum and the frame's gain.  So the work is
// two launches on the caller's stream (the global pass: a few a chunk):
//
//  A. the walk: one block per stream, one thread per band bin (as many warps
//     as the K band bins need; past 1,024 bins ceil(K / 1,024) a thread,
//     walk_plan), walks the frames in order with the
//     tracker, the SNR gate, the gain and the EMA, and writes the clipped
//     gain G (B, K, T) and the carries.  It reads only the band power K1
//     computed, the classes and the confidences, a round ahead.  A round
//     is kFrames frames between two barriers (fewer where the rows of
//     wide bands do not fit; in a global scratch where one frame's do
//     not): the tracker steps and the
//     EMA go frame after frame, but the SNR trees, the raw gains and the
//     smoothing of a round's frames are independent of each other, so their
//     dependent chains interleave (one warp per scheduler has no other warp
//     to hide them behind).
//  B. the frame pass: blocks over (stream, tile of frames) on all SMs.  Per
//     frame: the windowed frame, a real FFT (K1's half-length complex
//     Stockham transform, stockham_fft.cuh, with the real split), the band
//     rows scaled by G, the inverse real FFT (the same transform on the
//     conjugated half-length spectrum), the window, into shared memory;
//     then the overlap-add of each frame with the previous one, times
//     1 / sum(w^2), written as one contiguous run of y.  A tile's first
//     frame overlaps the frame before the tile, which the block computes
//     again by the same code (or takes from the carried tail at frame 0);
//     the block holding frame T - 1 writes the new tail.  This FFT route
//     takes n_fft from 64 to 1024, a power of two, as K1's FFT does (below
//     64 a group of n_fft / 16 threads would be under 4).
//  B'. the mixed frame pass, for every other even n_fft = 2 hop whose half
//     has no odd prime factor above 31 (384, 2,048 among them): the same
//     tiles and overlap-add with K1's mixed-radix FFT (mixed_fft.cuh), a
//     tile's frames frame-fastest in two shared buffers, the forward
//     transform, the real split and band scaling, the inverse's input and
//     the inverse transform each a block-wide step between them.
//  B''. the DFT frame pass, which only comparisons force: the same tiles,
//     staging and overlap-add, with K1's direct DFT (dft.cuh) in place of
//     the FFT: the tile's windowed frames frame-fastest in shared memory,
//     each thread one bin (forward) or one sample (inverse) of four frames,
//     the twiddles (k m) mod n_fft from the table in shared memory.
//  B3. the chirp-z frame pass, for every other even n_fft = 2 hop whose
//     tile of two frames fits: the mixed pass with both transforms of n_fft
//     / 2 points as chirp-z transforms over chirp_n points (four_step.cuh).
//  B4. the global frame pass, for every n_fft whose two frames no block
//     holds: the forward and inverse transforms as four-step FFTs (of n_fft
//     / 2, or chirp-z over chirp_n) through chunk buffers in device memory,
//     the split, scaling and overlap-add as launches between them.
//  The pass depends on n_fft alone (models/streaming.py::k8_route).
//
// Arithmetic.  The walk follows the plain loop
// (models/streaming.py::_suppressor_plain) operation for operation: every
// product, sum and quotient rounded on its own (__fmul_rn, __fadd_rn,
// __fsub_rn, __fdiv_rn, __fsqrt_rn, never contracted into an FMA), the SNR
// sums in the fixed tree order of the plain loop, NaN propagated by max and
// min; so the gain and the carries are the plain loop's bits.  The FFTs are
// float arithmetic of their own (the plain loop uses torch.fft), so the
// audio agrees with it to float rounding; no library FFT, whose algorithm
// may change with the batch shape, sits on the path.  Each frame's
// arithmetic is the same code wherever the frame lies in a tile, a chunk or
// a batch, so the output does not depend on how the stream is cut into
// chunks, nor on how many streams share a launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dft.cuh"
#include "four_step.cuh"
#include "mixed_fft.cuh"
#include "stockham_fft.cuh"

namespace {

constexpr int kMinFft = 64;
constexpr int kMaxFft = 1024;
constexpr int kMaxWalkThreads = 1024;
constexpr int kFrames = 4;            // frames a round of the walk takes between barriers
constexpr int kFrameThreads = 256;    // threads of a frame-pass block
constexpr int kMinSlots = 16;         // frames a frame-pass block holds at least
constexpr int kSmemLimit = 232448;    // dynamic shared memory a block may use

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || a < b) ? a : b;
}
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return nan_min(nan_max(v, lo), hi);
}

// Mirrored field for field by models/streaming.py::_SupConsts.
struct SupConsts {
  // the PSD tracker's step (trackers.cu's PsdConsts)
  float eta, scale_alpha, one_minus_scale_alpha, step_floor;
  int warmup_need;
  float q, neg_one_minus_q;
  int adaptive_q;
  float aq_min, q_minus_aq_min, ema_up, ema_down, track_maxr, aq_alpha, one_minus_aq_alpha;
  // N_eff and the SNR gate
  float maxr, eps;
  int use_lagged, n_snr;
  float snr1, snr_pwr;
  int snr_pow;
  // the gain
  int adaptive_gain, wiener;
  float th, denom, oversub_base, oversub_span, gain_floor, gain_ceil;
  int n_taps;  // 0: no frequency smoothing; the taps are SupIO::taps
  float alpha_base, one_minus_alpha_base;
  // geometry: n_fft = 2 hop; band bins row0 .. row0 + K - 1
  int n_fft, hop, K, row0, n_frames, n_streams;
  int chirp_n;  // the chirp-z transform's size (ops/spectrogram.py::chirp_size), 0 without one
};

// Mirrored field for field by models/streaming.py::_SupIO.
struct SupIO {
  const float* xa;  // (B, xa_len): the carried n_fft - hop samples, then the chunk
  long long xa_len;
  const float* P;  // band power: P[b * p_clip + (row0 + k) * p_row + t]
  long long p_clip, p_row;
  const int8_t* frame_class;  // (B, T); NOISE = 0
  const float* noise_conf;    // (B, T)
  const int* frame_idx;       // (B,): the stream's frames before this chunk
  // w (n_fft) | 1 / sum w^2 (hop) | a zero where hop is odd | e^{-2 pi i k / n_fft}
  // (n_fft pairs, 8-byte aligned: twiddle_offset)
  const float* tables;
  const int* snr_cols;        // (n_snr,) band bins of the SNR sums
  // carry in: tracker, scale, prev_n, g_prev (B, K); wcount, rain_ema,
  // is_first (B,); ola (B, n_fft - hop)
  const float *tracker, *scale, *prev_n;
  const int* wcount;
  const float* rain_ema;
  const uint8_t* is_first;
  const float *g_prev, *ola;
  float* y;  // (B, T * hop)
  // carry out (is_first is false after any frame)
  float *o_tracker, *o_scale, *o_prev_n;
  int* o_wcount;
  float* o_rain_ema;
  uint8_t* o_is_first;
  float *o_g_prev, *o_ola;
  float* gain;  // (B, K, T): the clipped gain per frame, from the walk to the frame pass
  const float* taps;  // (n_taps,): the frequency smoothing kernel
  // the chirp-z passes' tables (ops/spectrogram.py::chirpz_tables): the
  // chirp (n_fft / 2 pairs), Bt and e^{-2 pi i j / chirp_n} (chirp_n pairs)
  const float *chirp, *chirp_bt, *chirp_tab;
  // the walk's rows where they do not fit shared memory (walk_plan:
  // B x scratch floats) and the global frame pass's chunk buffers and
  // overlap-add tails (global_scratch_bytes)
  float* walk_scratch;
  long long walk_scratch_floats;
  float* frame_scratch;
  long long frame_scratch_bytes;
};

// where the twiddles start in SupIO::tables: after the window and 1 / sum
// w^2, padded to an even count of floats so that they are 8-byte aligned
__host__ __device__ inline int twiddle_offset(int n_fft, int hop) {
  return n_fft + hop + (hop & 1);
}

__host__ __device__ inline int pow2_at_least(int n) {
  int m = 1;
  while (m < n) m *= 2;
  return m;
}

// band bins a walk thread takes: as many as put a stream's bins in one block
__host__ __device__ inline int walk_bins_per_thread(int K) {
  return (K + kMaxWalkThreads - 1) / kMaxWalkThreads;
}

// floats of the walk's rows at F frames a round (WalkSmem): per frame the
// padded gain row twice, P and N_eff per band bin and the two SNR trees;
// then the taps
inline long long walk_floats(const SupConsts& c, int F) {
  const int pad = c.n_taps / 2;
  return (long long)F * (2 * (c.K + 2 * pad) + 2 * c.K + 2 * pow2_at_least(c.n_snr)) + c.n_taps;
}

// The walk's launch (models/streaming.py::k8_walk_plan): suppressor_walk
// (narrow) where K <= 1,024 and kFrames frames a round fit shared memory;
// else suppressor_walk_wide<frames> with the most frames a round (4, 2, 1)
// whose rows fit, or at one frame a round with the rows in a global scratch
// of `scratch` floats a stream.
struct WalkPlan {
  bool narrow;
  int frames, bpt, threads, smem;
  long long scratch;
};

WalkPlan walk_plan(const SupConsts& c) {
  WalkPlan w;
  w.bpt = walk_bins_per_thread(c.K);
  w.threads = 32 * (((c.K + w.bpt - 1) / w.bpt + 31) / 32);
  w.narrow = c.K <= kMaxWalkThreads && 4 * walk_floats(c, kFrames) <= kSmemLimit;
  w.scratch = 0;
  for (int F = kFrames; F >= 1; F /= 2) {
    if (4 * walk_floats(c, F) <= kSmemLimit) {
      w.frames = F;
      w.smem = (int)(4 * walk_floats(c, F));
      return w;
    }
  }
  w.frames = 1;
  w.smem = 0;
  w.scratch = walk_floats(c, 1);
  return w;
}

// The FFT frame pass's launch plan.
struct Plan {
  int slots, frame_smem;
};

Plan plan_for(const SupConsts& c) {
  const int M = c.n_fft / 2;
  const int fpr = kFrameThreads / max(M / 8, 1);  // frames a round of the FFT frame pass
  Plan p;
  p.slots = fpr >= kMinSlots ? fpr : kMinSlots;
  // exchange buffers | samples | frames | gains | Nyquist bins
  p.frame_smem = 4 * (2 * fpr * (M + 8) + (p.slots - 1) * c.hop + c.n_fft + p.slots * c.n_fft +
                      p.slots * c.K + fpr);
  return p;
}

// ---------------------------------------------------------------------------
// A. the walk
// ---------------------------------------------------------------------------
//
// Two kernels share every step below: suppressor_walk, one band bin a
// thread (K <= 1,024, the main path), and suppressor_walk_wide<F>, any K,
// band bin tid + j nt the thread's j-th.  The steps are inlined into both,
// so the arithmetic is written once; the kernels differ only in how a
// thread holds its bins and where the round's rows live.

// A walk block's shared memory.
struct WalkSmem {
  float *sG;    // [2][F][pad zeros | K gains | pad zeros], by round parity
  float *sP;    // [F][K]
  float *sNe;   // [F][K]
  float *red;   // [F][2][m]
  float *sTaps; // [n_taps]
  int grow, pad, m;
};

template <int F>
__device__ __forceinline__ WalkSmem walk_smem(float* sm, const SupConsts& c) {
  WalkSmem w;
  w.pad = c.n_taps / 2;
  w.m = pow2_at_least(c.n_snr);
  w.grow = c.K + 2 * w.pad;
  w.sG = sm;
  w.sP = w.sG + 2 * F * w.grow;
  w.sNe = w.sP + F * c.K;
  w.red = w.sNe + F * c.K;
  w.sTaps = w.red + 2 * F * w.m;
  return w;
}

// the taps, and the zero pads of the gain rows (before the first barrier)
template <int F>
__device__ __forceinline__ void walk_smem_init(const WalkSmem& w, const SupIO& io,
                                               const SupConsts& c, int tid, int nt) {
  for (int i = tid; i < c.n_taps; i += nt) w.sTaps[i] = io.taps[i];
  for (int i = tid; i < 2 * F * w.pad; i += nt) {
    const int r = i / w.pad, j = i - r * w.pad;
    w.sG[r * w.grow + j] = w.sG[r * w.grow + w.pad + c.K + j] = 0.f;
  }
}

// a frame's tracker steps up and down, from the stream's rain EMA
__device__ __forceinline__ void psd_steps(const SupConsts& c, float rain_ema, float& up,
                                          float& down) {
  const float q_eff = clamp(__fsub_rn(c.q, __fmul_rn(c.q_minus_aq_min, rain_ema)), c.aq_min, c.q);
  up = c.adaptive_q ? q_eff : c.q;
  down = c.adaptive_q ? -__fsub_rn(1.f, q_eff) : c.neg_one_minus_q;
}

// One band bin's PSD step over one frame of power pt: the tracker, its
// scale and the N EMA, changed only where the frame is live; returns N_eff.
__device__ __forceinline__ float psd_bin(const SupConsts& c, float pt, float& tracker,
                                         float& scale, float& prev_n, bool first, bool allow,
                                         bool seed, bool live, float up, float down,
                                         float one_minus_up, float one_minus_down) {
  const float err = __fsub_rn(pt, tracker);
  const float scale_new = __fadd_rn(__fmul_rn(c.scale_alpha, scale),
                                    __fmul_rn(c.one_minus_scale_alpha, fabsf(err)));
  const float step = __fmul_rn(c.eta, nan_max(scale_new, c.step_floor));
  const float delta = __fmul_rn((pt >= tracker) ? up : down, step);
  const float candidate = nan_max(__fadd_rn(tracker, delta), 0.f);
  const float tracker_new = (first || !allow) ? tracker : candidate;
  const float scale_out = first ? scale : scale_new;
  const bool rising = tracker_new > prev_n;
  const float n_ema = __fadd_rn(__fmul_rn(rising ? c.ema_up : c.ema_down, prev_n),
                                __fmul_rn(rising ? one_minus_up : one_minus_down, tracker_new));
  float n = first ? tracker_new : n_ema;
  n = nan_max(nan_min(n, __fmul_rn(c.track_maxr, pt)), 0.f);
  const float n_used = (c.use_lagged && !seed) ? prev_n : n;
  const float n_eff = nan_min(n_used, __fmul_rn(c.maxr, pt));
  if (live) {
    tracker = tracker_new;
    scale = scale_out;
    prev_n = n;
  }
  return n_eff;
}

// the stream's warm-up count, rain EMA and first flag after a live frame
__device__ __forceinline__ void psd_advance(const SupConsts& c, bool rain, bool allow,
                                            int& wcount, float& rain_ema, bool& first) {
  wcount += allow ? 1 : 0;
  rain_ema = __fadd_rn(__fmul_rn(c.aq_alpha, rain_ema),
                       __fmul_rn(c.one_minus_aq_alpha, rain ? 1.f : 0.f));
  first = false;
}

// The round's SNR gates, once every thread has stored its bins' P and
// N_eff in sP and sNe: per frame the two sums as a tree, element i + h
// onto i, the round's frames side by side.
template <int F>
__device__ __forceinline__ void snr_gates(const WalkSmem& w, const SupIO& io,
                                          const SupConsts& c, int tid, int nt, float (&gate)[F]) {
  const int K = c.K, m = w.m;
  float* const red = w.red;
  __syncthreads();
  for (int i = tid; i < F * m; i += nt) {
    const int f = i / m, j = i - f * m;
    const bool in = j < c.n_snr;
    const int col = in ? __ldg(io.snr_cols + j) : 0;
    red[2 * f * m + j] = in ? w.sP[f * K + col] : 0.f;
    red[2 * f * m + m + j] = in ? w.sNe[f * K + col] : 0.f;
  }
  __syncthreads();
  for (int h = m / 2; h >= 1; h /= 2) {
    for (int i = tid; i < F * h; i += nt) {
      const int f = i / h, j = i - f * h;
      float* const rf = red + 2 * f * m;
      rf[j] = __fadd_rn(rf[j], rf[j + h]);
      rf[m + j] = __fadd_rn(rf[m + j], rf[m + j + h]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const float snr = __fdiv_rn(red[2 * f * m], __fadd_rn(red[2 * f * m + m], c.eps));
    float g = __fdiv_rn(snr, __fadd_rn(snr, c.snr1));
    // gate ** p as exp(p log gate) in double, rounded once to float, as
    // the plain loop computes it (models/streaming.py::_gate_power)
    if (c.snr_pow) g = (float)exp(__dmul_rn(log((double)clamp(g, 0.f, 1.f)), (double)c.snr_pwr));
    gate[f] = clamp(g, 0.f, 1.f);
  }
}

// gain_freq_stage's per-frame terms: the clipped confidence, the
// oversubtraction and the EMA's alpha, the round's frames independent
template <int F>
__device__ __forceinline__ void gain_terms(const SupConsts& c, bool gated, const float (&na)[F],
                                           const float (&gate)[F], float (&ncc)[F],
                                           float (&over)[F], float (&alpha)[F]) {
#pragma unroll
  for (int f = 0; f < F; ++f) {
    ncc[f] = clamp(na[f], 0.f, 1.f);
    over[f] = c.oversub_base;
    alpha[f] = na[f] < c.th ? 0.f : __fmul_rn(c.alpha_base, __fdiv_rn(__fsub_rn(na[f], c.th), c.denom));
  }
  if (c.adaptive_gain) {
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const float eff = clamp(__fdiv_rn(__fsub_rn(ncc[f], c.th), c.denom), 0.f, 1.f);
      over[f] = __fadd_rn(__fmul_rn(eff, c.oversub_span), c.oversub_base);
      if (gated) over[f] = __fmul_rn(over[f], __fsub_rn(1.f, clamp(gate[f], 0.f, 1.f)));
    }
  }
}

// one band bin's raw gains of the round (sqrt-sub or Wiener)
template <int F>
__device__ __forceinline__ void raw_gains(const SupConsts& c, const float (&p)[F],
                                          const float (&n_eff)[F], const float (&over)[F],
                                          float (&g)[F]) {
  if (c.wiener) {
#pragma unroll
    for (int f = 0; f < F; ++f)
      g[f] = __fdiv_rn(nan_max(__fsub_rn(p[f], __fmul_rn(over[f], n_eff[f])), 0.f),
                       __fadd_rn(p[f], c.eps));
  } else {
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const float ratio = clamp(__fdiv_rn(n_eff[f], __fadd_rn(p[f], c.eps)), 0.f, 1.f);
      g[f] = __fsub_rn(1.f, __fmul_rn(over[f], __fsqrt_rn(ratio)));
    }
  }
}

// One band bin kk's gains of the round, from the round's raw gain rows
// sGr: the smoothing over frequency (frames independent), then the EMA over
// time frame after frame; each live frame's clipped gain goes to out[f]
// where the thread holds the bin.
template <int F>
__device__ __forceinline__ void smooth_and_ema(const WalkSmem& w, const float* sGr,
                                               const SupConsts& c, int kk, bool lane, int nf,
                                               const float (&na)[F], const float (&ncc)[F],
                                               const float (&alpha)[F], const bool (&seed)[F],
                                               float& g_prev, float* out) {
  float gf[F];
#pragma unroll
  for (int f = 0; f < F; ++f) gf[f] = sGr[f * w.grow + w.pad + kk];
  if (c.n_taps > 0) {
    float conv[F];
#pragma unroll
    for (int f = 0; f < F; ++f) conv[f] = 0.f;
    for (int i = 0; i < c.n_taps; ++i) {
#pragma unroll
      for (int f = 0; f < F; ++f)
        conv[f] = __fadd_rn(conv[f], __fmul_rn(w.sTaps[i], sGr[f * w.grow + kk + i]));
    }
#pragma unroll
    for (int f = 0; f < F; ++f)
      if (!c.adaptive_gain || ncc[f] >= c.th) gf[f] = conv[f];
  }
#pragma unroll
  for (int f = 0; f < F; ++f) {
    float gt;
    if (c.adaptive_gain) {
      gt = __fadd_rn(__fmul_rn(alpha[f], g_prev), __fmul_rn(__fsub_rn(1.f, alpha[f]), gf[f]));
      if (na[f] < c.th) gt = nan_max(gt, gf[f]);
    } else {
      gt = __fadd_rn(__fmul_rn(c.alpha_base, g_prev), __fmul_rn(c.one_minus_alpha_base, gf[f]));
    }
    if (seed[f]) gt = gf[f];
    if (f < nf) {
      g_prev = gt;
      if (lane) out[f] = clamp(gt, c.gain_floor, c.gain_ceil);
    }
  }
}

__global__ void __launch_bounds__(kMaxWalkThreads) suppressor_walk(SupIO io, SupConsts c) {
  extern __shared__ float sm[];
  constexpr int F = kFrames;
  const WalkSmem w = walk_smem<F>(sm, c);
  const int K = c.K, T = c.n_frames;
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  walk_smem_init<F>(w, io, c, tid, nt);

  const bool lane = tid < K;
  const int kk = lane ? tid : 0;  // a band bin the thread may read for
  const long long lk = (long long)b * K + tid;
  float tracker = 0.f, scale = 0.f, prev_n = 0.f, g_prev = 0.f;
  if (lane) {
    tracker = io.tracker[lk];
    scale = io.scale[lk];
    prev_n = io.prev_n[lk];
    g_prev = io.g_prev[lk];
  }
  int wcount = io.wcount[b];
  float rain_ema = io.rain_ema[b];
  bool first = io.is_first[b] != 0;
  const int frame0 = io.frame_idx[b];
  const float* const prow = io.P + (long long)b * io.p_clip + (long long)(c.row0 + kk) * io.p_row;
  const int8_t* const crow = io.frame_class + (long long)b * T;
  const float* const nrow = io.noise_conf + (long long)b * T;
  float* const grow_out = io.gain + lk * T;
  const float one_minus_up = __fsub_rn(1.f, c.ema_up);
  const float one_minus_down = __fsub_rn(1.f, c.ema_down);
  const bool gated = c.n_snr > 0;

  // the next round's inputs are loaded while this round runs
  float pa[F], na[F];
  int ca[F];
#pragma unroll
  for (int f = 0; f < F; ++f) {
    pa[f] = lane && f < T ? prow[f] : 0.f;
    ca[f] = f < T ? crow[f] : 0;
    na[f] = f < T ? nrow[f] : 0.f;
  }
  __syncthreads();

  for (int t0 = 0, round = 0; t0 < T; t0 += F, ++round) {
    float pn[F], nn[F];
    int cn[F];
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const int t = t0 + F + f;
      pn[f] = lane && t < T ? prow[t] : 0.f;
      cn[f] = t < T ? crow[t] : 0;
      nn[f] = t < T ? nrow[t] : 0.f;
    }
    // frame t0 + f is `live` for f < nf; a frame past T changes no carry
    const int nf = min(F, T - t0);
    float n_eff[F], gate[F];
    bool seed[F];

    // ---- the PSD steps and N_eff, frame after frame ----
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const bool live = f < nf;
      const bool rain = ca[f] != 0;
      seed[f] = frame0 + t0 + f == 0;
      const bool allow = (wcount < c.warmup_need) || !rain;
      float up, down;
      psd_steps(c, rain_ema, up, down);
      n_eff[f] = psd_bin(c, pa[f], tracker, scale, prev_n, first, allow, seed[f], live, up, down,
                         one_minus_up, one_minus_down);
      if (live) psd_advance(c, rain, allow, wcount, rain_ema, first);
      gate[f] = 0.f;
    }

    // ---- the SNR gates ----
    if (gated) {
      if (lane) {
#pragma unroll
        for (int f = 0; f < F; ++f) {
          w.sP[f * K + tid] = pa[f];
          w.sNe[f * K + tid] = n_eff[f];
        }
      }
      snr_gates(w, io, c, tid, nt, gate);
    }

    // ---- gain_freq_stage: the raw gains, the round's frames independent ----
    float ncc[F], over[F], alpha[F], g[F];
    gain_terms(c, gated, na, gate, ncc, over, alpha);
    float* const sGr = w.sG + (round & 1) * F * w.grow;
    raw_gains(c, pa, n_eff, over, g);
    if (lane) {
#pragma unroll
      for (int f = 0; f < F; ++f) sGr[f * w.grow + w.pad + tid] = clamp(g[f], c.gain_floor, c.gain_ceil);
    }
    __syncthreads();

    // ---- the smoothing over frequency, then the EMA over time ----
    smooth_and_ema(w, sGr, c, kk, lane, nf, na, ncc, alpha, seed, g_prev, grow_out + t0);
#pragma unroll
    for (int f = 0; f < F; ++f) {
      pa[f] = pn[f];
      ca[f] = cn[f];
      na[f] = nn[f];
    }
  }

  if (lane) {
    io.o_tracker[lk] = tracker;
    io.o_scale[lk] = scale;
    io.o_prev_n[lk] = prev_n;
    io.o_g_prev[lk] = g_prev;
  }
  if (tid == 0) {
    io.o_wcount[b] = wcount;
    io.o_rain_ema[b] = rain_ema;
    io.o_is_first[b] = 0;
  }
}

// The walk past one bin a thread (K > 1,024), or where a round of kFrames
// frames does not fit shared memory: band bin tid + j nt is the thread's
// j-th, j < bpt (a runtime count, ceil(K / 1,024)), F frames a round (4, 2
// or 1, as many as fit).  A bin's carries live in the carry-out arrays,
// which only its thread reads and writes; the round's rows (WalkSmem) in
// shared memory or, where even one frame a round does not fit, in the
// stream's part of SupIO::walk_scratch (L2-resident at these sizes).  The
// stream's terms of a round's frames (the tracker's steps, the warm-up and
// first flags) are taken frame after frame first, then each bin steps
// through the round's frames: every bin sees the same frame sequence and
// the same arithmetic as in suppressor_walk.
template <int F>
__global__ void __launch_bounds__(kMaxWalkThreads)
suppressor_walk_wide(SupIO io, SupConsts c, int bpt, long long scratch_floats) {
  extern __shared__ float sm[];
  const int K = c.K, T = c.n_frames;
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const WalkSmem w =
      walk_smem<F>(scratch_floats > 0 ? io.walk_scratch + b * scratch_floats : sm, c);
  walk_smem_init<F>(w, io, c, tid, nt);
  for (int j = 0; j < bpt && tid + j * nt < K; ++j) {
    const long long lk = (long long)b * K + tid + j * nt;
    io.o_tracker[lk] = io.tracker[lk];
    io.o_scale[lk] = io.scale[lk];
    io.o_prev_n[lk] = io.prev_n[lk];
    io.o_g_prev[lk] = io.g_prev[lk];
  }
  int wcount = io.wcount[b];
  float rain_ema = io.rain_ema[b];
  bool first = io.is_first[b] != 0;
  const int frame0 = io.frame_idx[b];
  const int8_t* const crow = io.frame_class + (long long)b * T;
  const float* const nrow = io.noise_conf + (long long)b * T;
  const float one_minus_up = __fsub_rn(1.f, c.ema_up);
  const float one_minus_down = __fsub_rn(1.f, c.ema_down);
  const bool gated = c.n_snr > 0;
  __syncthreads();

  for (int t0 = 0, round = 0; t0 < T; t0 += F, ++round) {
    const int nf = min(F, T - t0);
    float na[F], up[F], down[F], gate[F];
    bool fst[F], allow[F], seed[F];

    // ---- the stream's terms of the round's frames, frame after frame ----
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const int t = t0 + f;
      const bool rain = t < T && crow[t] != 0;
      na[f] = t < T ? nrow[t] : 0.f;
      seed[f] = frame0 + t == 0;
      allow[f] = (wcount < c.warmup_need) || !rain;
      psd_steps(c, rain_ema, up[f], down[f]);
      fst[f] = first;
      if (f < nf) psd_advance(c, rain, allow[f], wcount, rain_ema, first);
      gate[f] = 0.f;
    }

    // ---- the PSD steps and N_eff of the thread's bins, frame after frame ----
    for (int j = 0; j < bpt && tid + j * nt < K; ++j) {
      const int k = tid + j * nt;
      const long long lk = (long long)b * K + k;
      float tracker = io.o_tracker[lk], scale = io.o_scale[lk], prev_n = io.o_prev_n[lk];
      const float* const prow =
          io.P + (long long)b * io.p_clip + (long long)(c.row0 + k) * io.p_row;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const float pt = t0 + f < T ? prow[t0 + f] : 0.f;
        w.sP[f * K + k] = pt;
        w.sNe[f * K + k] = psd_bin(c, pt, tracker, scale, prev_n, fst[f], allow[f], seed[f],
                                   f < nf, up[f], down[f], one_minus_up, one_minus_down);
      }
      io.o_tracker[lk] = tracker;
      io.o_scale[lk] = scale;
      io.o_prev_n[lk] = prev_n;
    }

    // ---- the SNR gates ----
    if (gated) snr_gates(w, io, c, tid, nt, gate);

    // ---- gain_freq_stage: the raw gains, the round's frames independent ----
    float ncc[F], over[F], alpha[F];
    gain_terms(c, gated, na, gate, ncc, over, alpha);
    float* const sGr = w.sG + (round & 1) * F * w.grow;
    for (int j = 0; j < bpt && tid + j * nt < K; ++j) {
      const int k = tid + j * nt;
      float pa[F], n_eff[F], g[F];
#pragma unroll
      for (int f = 0; f < F; ++f) {
        pa[f] = w.sP[f * K + k];
        n_eff[f] = w.sNe[f * K + k];
      }
      raw_gains(c, pa, n_eff, over, g);
#pragma unroll
      for (int f = 0; f < F; ++f)
        sGr[f * w.grow + w.pad + k] = clamp(g[f], c.gain_floor, c.gain_ceil);
    }
    __syncthreads();

    // ---- the smoothing over frequency, then the EMA over time ----
    for (int j = 0; j < bpt && tid + j * nt < K; ++j) {
      const long long lk = (long long)b * K + tid + j * nt;
      float g_prev = io.o_g_prev[lk];
      smooth_and_ema(w, sGr, c, tid + j * nt, true, nf, na, ncc, alpha, seed, g_prev,
                     io.gain + lk * T + t0);
      io.o_g_prev[lk] = g_prev;
    }
  }

  if (tid == 0) {
    io.o_wcount[b] = wcount;
    io.o_rain_ema[b] = rain_ema;
    io.o_is_first[b] = 0;
  }
}

// ---------------------------------------------------------------------------
// B. the frame pass
// ---------------------------------------------------------------------------

// The frames of one tile: slot s holds frame t0 - 1 + s.  The windowed
// samples start at slab + s hop; the frame's gains (K band bins) at
// gains + s K; the windowed inverse goes to rec + s n_fft where `live`.

// K1's transform, a group of G = M / 8 threads per frame.
template <int M>
__device__ __forceinline__ void group_frames(const float* slab, float* rec, const float* gains,
                                             float* xm, float2* exch, const float* window,
                                             const float2* tw, int slots, int t0, int T, int K,
                                             int row0) {
  constexpr int N = 2 * M, G = M / 8, FPR = kFrameThreads / G;
  constexpr int R2 = M / 8 < 8 ? M / 8 : 8;
  constexpr int R3 = M > 64 ? M / 64 : 1;
  const int t = threadIdx.x % G, grp = threadIdx.x / G;
  float2* const buf = exch + grp * (M + 8);
  float2 win[8], tw2[8], tw3[8], tws[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int m = t + r * G;
    win[r] = make_float2(__ldg(window + 2 * m), __ldg(window + 2 * m + 1));
    tws[r] = __ldg(tw + m);
  }
  pass_twiddles<M, R2, 8>(tw, t, tw2);
  if constexpr (M > 64) pass_twiddles<M, R3, 64>(tw, t, tw3);
  constexpr float inv_n = 1.f / N;

#pragma unroll 1
  for (int s0 = 0; s0 < slots; s0 += FPR) {
    const int sl = s0 + grp;
    const int tf = t0 - 1 + sl;
    const bool live = tf >= 0 && tf < T;

    // ---- forward: the windowed frame, Z = FFT_M(x[2m] + i x[2m+1]) ----
    float2 v[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float2 s = *reinterpret_cast<const float2*>(slab + sl * M + 2 * (t + r * G));
      v[r] = make_float2(s.x * win[r].x, s.y * win[r].y);
    }
    first_radix8<M>(v, buf, t);
    stockham_pass<M, R2, 8>(buf, t, tw2);
    if constexpr (M > 64) stockham_pass<M, R3, 64>(buf, t, tw3);

    // ---- the real split, X[k] for k = t + q G (and X[M] by thread 0),
    // the band rows scaled by the frame's gain ----
    float2 X[8];
    float x_m = 0.f;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int k = t + q * G;
      const float2 zk = buf[swz(k)];
      const float2 zm = buf[swz((M - k) & (M - 1))];
      const float ar = 0.5f * (zk.x + zm.x), ai = 0.5f * (zk.y - zm.y);
      const float dr = 0.5f * (zk.x - zm.x), di = 0.5f * (zk.y + zm.y);
      const float2 w = tws[q];
      X[q] = make_float2(ar + (w.x * di + w.y * dr), ai - (w.x * dr - w.y * di));
      const int kb = k - row0;
      if (kb >= 0 && kb < K) {
        const float g = gains[sl * K + kb];
        X[q] = make_float2(__fmul_rn(X[q].x, g), __fmul_rn(X[q].y, g));
      }
    }
    if (t == 0) {
      const float2 z0 = buf[swz(0)];
      x_m = z0.x - z0.y;
      const int kb = M - row0;
      if (kb >= 0 && kb < K) x_m = __fmul_rn(x_m, gains[sl * K + kb]);
      X[0].y = 0.f;  // the inverse real FFT takes the real part of bins 0 and M
    }
    group_sync<G>();  // every read of Z is done
#pragma unroll
    for (int q = 0; q < 8; ++q) buf[swz(t + q * G)] = X[q];
    if (t == 0) xm[grp] = x_m;
    group_sync<G>();

    // ---- inverse: 2 Z[k] = (X[k] + conj X[M-k]) + i (X[k] - conj X[M-k])
    // e^{2 pi i k / N}; then x[2m] + i x[2m+1] = conj(FFT_M(conj 2Z))[m] / N ----
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int k = t + q * G;
      const float2 xk = X[q];
      const float2 xr = k == 0 ? make_float2(xm[grp], 0.f) : buf[swz(M - k)];
      const float ar = xk.x + xr.x, ai = xk.y - xr.y;
      const float dr = xk.x - xr.x, di = xk.y + xr.y;
      const float2 w = tws[q];  // e^{-2 pi i k / N}
      const float br = dr * w.x + di * w.y, bi = di * w.x - dr * w.y;
      v[q] = make_float2(ar - bi, -(ai + br));
    }
    group_sync<G>();  // every read of X is done
    first_radix8<M>(v, buf, t);
    stockham_pass<M, R2, 8>(buf, t, tw2);
    if constexpr (M > 64) stockham_pass<M, R3, 64>(buf, t, tw3);
    if (live) {
      float* const out = rec + sl * N;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int m = t + q * G;
        const float2 s = buf[swz(m)];
        *reinterpret_cast<float2*>(out + 2 * m) =
            make_float2((s.x * inv_n) * win[q].x, (-s.y * inv_n) * win[q].y);
      }
    }
    group_sync<G>();  // the buffer is free for the next round
  }
}

template <int M>
__global__ void __launch_bounds__(kFrameThreads)
suppressor_frames(SupIO io, SupConsts c, int slots, int n_tiles) {
  extern __shared__ float4 smem4[];
  constexpr int N = 2 * M, hop = M;
  constexpr int FPR = kFrameThreads / (M / 8);
  const int K = c.K, T = c.n_frames;
  const int b = blockIdx.x / n_tiles;
  const int FT = slots - 1;
  const int t0 = (blockIdx.x - b * n_tiles) * FT;
  float* const base = reinterpret_cast<float*>(smem4);
  float2* const exch = reinterpret_cast<float2*>(base);
  float* const slab = base + 2 * FPR * (M + 8);
  const int slab_n = (slots - 1) * hop + N;
  float* const rec = slab + slab_n;      // [slots][N]
  float* const gains = rec + slots * N;  // [slots][K]
  float* const xm = gains + slots * K;   // [FPR]
  const float* const window = io.tables;
  const float* const inv_ws = io.tables + N;
  const float2* const tw = reinterpret_cast<const float2*>(io.tables + twiddle_offset(N, hop));
  const int tid = threadIdx.x;

  // ---- stage the tile's samples, gains and, at frame 0, the carried tail ----
  const long long s_start = (long long)(t0 - 1) * hop;
  const float* const xrow = io.xa + (long long)b * io.xa_len;
  for (int i = tid; i < slab_n; i += kFrameThreads) {
    const long long s = s_start + i;
    slab[i] = (s >= 0 && s < io.xa_len) ? xrow[s] : 0.f;
  }
  const float* const grow = io.gain + (long long)b * K * T;
  for (int i = tid; i < slots * K; i += kFrameThreads) {
    const int k = i / slots, sl = i - k * slots;
    const int t = t0 - 1 + sl;
    gains[sl * K + k] = (t >= 0 && t < T) ? grow[(long long)k * T + t] : 0.f;
  }
  if (t0 == 0)
    for (int i = tid; i < N - hop; i += kFrameThreads) rec[hop + i] = io.ola[(long long)b * (N - hop) + i];
  __syncthreads();

  group_frames<M>(slab, rec, gains, xm, exch, window, tw, slots, t0, T, K, c.row0);
  __syncthreads();

  // ---- the overlap-add of frames t0 .. t0 + nf - 1: one run of y ----
  const int nf = min(FT, T - t0);
  float* const yb = io.y + (long long)b * T * hop + (long long)t0 * hop;
  for (int i = tid; i < nf * hop; i += kFrameThreads) {
    const int f = i / hop, n = i - f * hop;  // frame t0 + f is slot f + 1
    yb[i] = __fmul_rn(__fadd_rn(rec[(f + 1) * N + n], rec[f * N + hop + n]), __ldg(inv_ws + n));
  }
  if (t0 + FT >= T) {  // frame T - 1 is here: its tail is the next chunk's
    const float* const last = rec + (T - t0) * N + hop;
    for (int i = tid; i < N - hop; i += kFrameThreads) io.o_ola[(long long)b * (N - hop) + i] = last[i];
  }
}

// ---------------------------------------------------------------------------
// B'. the mixed frame pass
// ---------------------------------------------------------------------------

// X[k], k < M, of an even frame from its half-length transform Z: zk = Z[k],
// zm = Z[M - k] (Z[0] at k = 0), w = e^{-2 pi i k / n_fft}
__device__ __forceinline__ float2 split_bin(float2 zk, float2 zm, float2 w) {
  const float ar = 0.5f * (zk.x + zm.x), ai = 0.5f * (zk.y - zm.y);
  const float dr = 0.5f * (zk.x - zm.x), di = 0.5f * (zk.y + zm.y);
  return make_float2(ar + (w.x * di + w.y * dr), ai - (w.x * dr - w.y * di));
}

// The inverse's input u[k], k < M: 2 Z[k] = (X[k] + conj X[M-k]) + i (X[k] -
// conj X[M-k]) e^{2 pi i k / N}, as conj(2 Z[k]); xk = X[k], xr = X[M - k]
// (X[M] at k = 0), w = e^{-2 pi i k / n_fft}.  Then x[2m] + i x[2m+1] =
// conj(FFT_M(u))[m] / N.
__device__ __forceinline__ float2 unsplit_bin(float2 xk, float2 xr, float2 w) {
  const float ar = xk.x + xr.x, ai = xk.y - xr.y;
  const float dr = xk.x - xr.x, di = xk.y + xr.y;
  const float br = dr * w.x + di * w.y, bi = di * w.x - dr * w.y;
  return make_float2(ar - bi, -(ai + br));
}

// X[k] of bin k <= M of a frame, from Z (z(j) = Z[j]), times the frame's
// gain where k is a band bin (gain(kb), kb = k - row0); the imaginary parts
// of bins 0 and M are dropped, as an inverse real FFT ignores them.
template <typename ZOf, typename GainOf>
__device__ __forceinline__ float2 scaled_bin(ZOf z, GainOf gain, const float2* __restrict__ tw,
                                             int k, int M, int row0, int K) {
  float2 v;
  if (k < M) {
    v = split_bin(z(k), z(k == 0 ? 0 : M - k), __ldg(tw + k));
  } else {
    const float2 z0 = z(0);
    v = make_float2(z0.x - z0.y, 0.f);
  }
  const int kb = k - row0;
  if (kb >= 0 && kb < K) {
    const float g = gain(kb);
    v = make_float2(__fmul_rn(v.x, g), __fmul_rn(v.y, g));
  }
  if (k == 0 || k == M) v.y = 0.f;
  return v;
}

// shared bytes of a mixed frame-pass block holding `slots` frames (a power
// of two): two tile buffers of n_fft / 2 + 1 points (the samples are staged
// in the second) | the gains
__host__ __device__ inline int mixed_frame_smem(int n_fft, int K, int slots) {
  return 16 * tile_elems(n_fft / 2 + 1, slots) + 4 * slots * K;
}

// the most slots (a power of two, at most kMinSlots, at least 2) that fit
int mixed_slots(int n_fft, int K) {
  for (int slots = kMinSlots; slots >= 2; slots /= 2)
    if (mixed_frame_smem(n_fft, K, slots) <= kSmemLimit) return slots;
  return 0;
}

template <int kW>
__global__ void __launch_bounds__(kFrameThreads)
suppressor_frames_mixed(SupIO io, SupConsts c, int lg, int n_tiles, MixedPlan plan) {
  extern __shared__ float4 smem4[];
  const int N = c.n_fft, hop = c.hop, M = N / 2, K = c.K, T = c.n_frames;
  const int slots = 1 << lg, ld = tile_ld(slots), FT = slots - 1;
  const int b = blockIdx.x / n_tiles;
  const int t0 = (blockIdx.x - b * n_tiles) * FT;
  float2* const buf_a = reinterpret_cast<float2*>(smem4);
  float2* const buf_b = buf_a + tile_elems(M + 1, slots);
  float* const gains = reinterpret_cast<float*>(buf_b + tile_elems(M + 1, slots));  // [slots][K]
  const float* const window = io.tables;
  const float* const inv_ws = io.tables + N;
  const float2* const tw = reinterpret_cast<const float2*>(io.tables + twiddle_offset(N, hop));
  const int tid = threadIdx.x;

  // ---- stage the tile's samples (slot s: frame t0 - 1 + s) and gains ----
  const float* const slab = stage_run(io.xa + (long long)b * io.xa_len, io.xa_len,
                                      (long long)(t0 - 1) * hop, FT * hop + N,
                                      reinterpret_cast<float*>(buf_b));
  const float* const grow = io.gain + (long long)b * K * T;
  for (int i = tid; i < slots * K; i += kFrameThreads) {
    const int k = i / slots, sl = i - k * slots;
    const int t = t0 - 1 + sl;
    gains[sl * K + k] = (t >= 0 && t < T) ? grow[(long long)k * T + t] : 0.f;
  }
  __syncthreads();
  pack_frames(slab, hop, window, buf_a, M, slots, ld);
  __syncthreads();

  // ---- forward: Z = FFT_M(x[2m] + i x[2m+1]) of every slot ----
  float2* const Z = mixed_fft<kW>(buf_a, buf_b, tw, N, M, lg, ld, plan);
  float2* const X = Z == buf_a ? buf_b : buf_a;

  // ---- the real split, X[k] for k <= M, the band rows scaled by the
  // frame's gain; the inverse real FFT takes the real part of bins 0 and M ----
  for (int i = tid; i < ((M + 1) << lg); i += kFrameThreads) {
    const int f = i & (slots - 1), k = i >> lg;
    X[k * ld + f] = scaled_bin([&](int j) { return Z[j * ld + f]; },
                               [&](int kb) { return gains[f * K + kb]; }, tw, k, M, c.row0, K);
  }
  __syncthreads();

  // ---- inverse: 2 Z[k] = (X[k] + conj X[M-k]) + i (X[k] - conj X[M-k])
  // e^{2 pi i k / N}, into Z's buffer as conj(2 Z); then x[2m] + i x[2m+1]
  // = conj(FFT_M(conj 2Z))[m] / N ----
  for (int i = tid; i < (M << lg); i += kFrameThreads) {
    const int f = i & (slots - 1), k = i >> lg;
    Z[k * ld + f] = unsplit_bin(X[k * ld + f], X[(M - k) * ld + f], __ldg(tw + k));
  }
  __syncthreads();
  const float2* const Y = mixed_fft<kW>(Z, X, tw, N, M, lg, ld, plan);

  // ---- the overlap-add of frames t0 .. t0 + nf - 1: one run of y; sample
  // j of slot s's windowed inverse is rec(s, j), the carried tail at frame 0 ----
  const float inv_n = 1.f / (float)N;
  auto rec = [&](int s, int j) {
    const float2 v = Y[(j >> 1) * ld + s];
    return (j & 1) ? (-v.y * inv_n) * __ldg(window + j) : (v.x * inv_n) * __ldg(window + j);
  };
  const float* const ola = io.ola + (long long)b * (N - hop);
  const int nf = min(FT, T - t0);
  float* const yb = io.y + (long long)b * T * hop + (long long)t0 * hop;
  for (int i = tid; i < nf * hop; i += kFrameThreads) {
    const int f = i / hop, n = i - f * hop;  // frame t0 + f is slot f + 1
    const float prev = (f == 0 && t0 == 0) ? ola[n] : rec(f, hop + n);
    yb[i] = __fmul_rn(__fadd_rn(rec(f + 1, n), prev), __ldg(inv_ws + n));
  }
  if (t0 + FT >= T) {  // frame T - 1 is here: its tail is the next chunk's
    const int s = T - t0;
    for (int i = tid; i < N - hop; i += kFrameThreads)
      io.o_ola[(long long)b * (N - hop) + i] = rec(s, hop + i);
  }
}

// ---------------------------------------------------------------------------
// B3. the chirp-z frame pass
// ---------------------------------------------------------------------------
//
// For every n_fft = 2 hop whose half M has a prime factor above 31: the
// mixed pass's tiles, split, scaling and overlap-add, with both transforms
// of M points as chirp-z transforms over Mc = chirp_n points (four_step.cuh
// states it): a tile's frames frame-fastest in two buffers of Mc points.

// shared bytes of a chirp-z frame-pass block holding `slots` frames (a
// power of two): two tile buffers of Mc points | the gains
__host__ __device__ inline int chirpz_frame_smem(int Mc, int K, int slots) {
  return 16 * tile_elems(Mc, slots) + 4 * slots * K;
}

// the most slots (a power of two, at most kMinSlots, at least 2) that fit
int chirpz_slots(int Mc, int K) {
  for (int slots = kMinSlots; slots >= 2; slots /= 2)
    if (chirpz_frame_smem(Mc, K, slots) <= kSmemLimit) return slots;
  return 0;
}

__global__ void __launch_bounds__(kFrameThreads)
suppressor_frames_chirpz(SupIO io, SupConsts c, int lg, int n_tiles, MixedPlan plan) {
  extern __shared__ float4 smem4[];
  const int N = c.n_fft, hop = c.hop, M = N / 2, K = c.K, T = c.n_frames, Mc = c.chirp_n;
  const int slots = 1 << lg, ld = tile_ld(slots), FT = slots - 1;
  const int b = blockIdx.x / n_tiles;
  const int t0 = (blockIdx.x - b * n_tiles) * FT;
  float2* const buf_a = reinterpret_cast<float2*>(smem4);
  float2* const buf_b = buf_a + tile_elems(Mc, slots);
  float* const gains = reinterpret_cast<float*>(buf_b + tile_elems(Mc, slots));  // [slots][K]
  const float* const window = io.tables;
  const float* const inv_ws = io.tables + N;
  const float2* const tw = reinterpret_cast<const float2*>(io.tables + twiddle_offset(N, hop));
  const float2* const chirp = reinterpret_cast<const float2*>(io.chirp);
  const float2* const bt = reinterpret_cast<const float2*>(io.chirp_bt);
  const float2* const ctab = reinterpret_cast<const float2*>(io.chirp_tab);
  const int tid = threadIdx.x;

  // ---- stage the tile's samples (slot s: frame t0 - 1 + s) and gains ----
  const float* const slab = stage_run(io.xa + (long long)b * io.xa_len, io.xa_len,
                                      (long long)(t0 - 1) * hop, FT * hop + N,
                                      reinterpret_cast<float*>(buf_b));
  const float* const grow = io.gain + (long long)b * K * T;
  for (int i = tid; i < slots * K; i += kFrameThreads) {
    const int k = i / slots, sl = i - k * slots;
    const int t = t0 - 1 + sl;
    gains[sl * K + k] = (t >= 0 && t < T) ? grow[(long long)k * T + t] : 0.f;
  }
  __syncthreads();
  // the windowed, packed points times the chirp, zero-padded to Mc
  for (int i = tid; i < slots * Mc; i += kFrameThreads) {
    const int f = i / Mc, m = i - f * Mc;
    float2 v = make_float2(0.f, 0.f);
    if (m < M) {
      const float* const sf = slab + f * hop + 2 * m;
      v = cmul(make_float2(sf[0] * __ldg(window + 2 * m), sf[1] * __ldg(window + 2 * m + 1)),
               __ldg(chirp + m));
    }
    buf_a[m * ld + f] = v;
  }
  __syncthreads();

  // ---- forward: Z[k] = conj(W[k]) c_k, k < M; the split and scaling ----
  float2* const W = chirp_convolve(buf_a, buf_b, ctab, bt, Mc, lg, ld, plan);
  float2* const X = W == buf_a ? buf_b : buf_a;
  for (int i = tid; i < ((M + 1) << lg); i += kFrameThreads) {
    const int f = i & (slots - 1), k = i >> lg;
    X[k * ld + f] = scaled_bin(
        [&](int j) {
          const float2 w = W[j * ld + f];
          return cmul(make_float2(w.x, -w.y), __ldg(chirp + j));
        },
        [&](int kb) { return gains[f * K + kb]; }, tw, k, M, c.row0, K);
  }
  __syncthreads();

  // ---- inverse: u[k] c_k, k < M, zero-padded, into W's buffer; FFT_M(u)[m]
  // = conj(V[m]) c_m ----
  for (int i = tid; i < (Mc << lg); i += kFrameThreads) {
    const int f = i & (slots - 1), k = i >> lg;
    W[k * ld + f] = k < M ? cmul(unsplit_bin(X[k * ld + f], X[(M - k) * ld + f], __ldg(tw + k)),
                                 __ldg(chirp + k))
                          : make_float2(0.f, 0.f);
  }
  __syncthreads();
  const float2* const V = chirp_convolve(W, X, ctab, bt, Mc, lg, ld, plan);

  // ---- the overlap-add, as the mixed pass's ----
  const float inv_n = 1.f / (float)N;
  auto rec = [&](int s, int j) {
    const float2 w = V[(j >> 1) * ld + s];
    const float2 v = cmul(make_float2(w.x, -w.y), __ldg(chirp + (j >> 1)));
    return (j & 1) ? (-v.y * inv_n) * __ldg(window + j) : (v.x * inv_n) * __ldg(window + j);
  };
  const float* const ola = io.ola + (long long)b * (N - hop);
  const int nf = min(FT, T - t0);
  float* const yb = io.y + (long long)b * T * hop + (long long)t0 * hop;
  for (int i = tid; i < nf * hop; i += kFrameThreads) {
    const int f = i / hop, n = i - f * hop;  // frame t0 + f is slot f + 1
    const float prev = (f == 0 && t0 == 0) ? ola[n] : rec(f, hop + n);
    yb[i] = __fmul_rn(__fadd_rn(rec(f + 1, n), prev), __ldg(inv_ws + n));
  }
  if (t0 + FT >= T) {  // frame T - 1 is here: its tail is the next chunk's
    const int s = T - t0;
    for (int i = tid; i < N - hop; i += kFrameThreads)
      io.o_ola[(long long)b * (N - hop) + i] = rec(s, hop + i);
  }
}

// ---------------------------------------------------------------------------
// B4. the global frame pass
// ---------------------------------------------------------------------------
//
// For every n_fft whose frames no block holds two of: the frames of all
// streams, g = b T + t, go through in chunks (four_step.cuh's chunk
// buffers).  Per chunk: the forward transform of M points of every frame
// into buffer B (the four-step FFT of M, or the chirp-z transform over
// chirp_n); the split, scaling and inverse input, a thread a pair of bins
// (k, M - k) in place (global_split_gain); the inverse transform into B;
// the overlap-add, a thread a sample (global_overlap_add).  The frame
// before a chunk's first lies in the previous chunk: its windowed tail is
// kept in one of two tail buffers, by chunk parity.

__global__ void __launch_bounds__(kFrameThreads)
global_split_gain(SupIO io, SupConsts c, float2* Z, long long zs, long long g0, int n_ktiles) {
  const int f = blockIdx.x / n_ktiles;
  const int k = (blockIdx.x - f * n_ktiles) * kFrameThreads + threadIdx.x;
  const int N = c.n_fft, M = N / 2, K = c.K, T = c.n_frames;
  if (k > M / 2) return;
  const long long g = g0 + f, b = g / T, t = g - b * T;
  const float2* const tw = reinterpret_cast<const float2*>(io.tables + twiddle_offset(N, c.hop));
  const float* const grow = io.gain + b * K * T + t;
  float2* const z = Z + f * zs;
  auto gain = [&](int kb) { return grow[(long long)kb * T]; };
  const float2 zk = z[k], zm = z[k == 0 ? 0 : M - k];
  auto zof = [&](int j) { return j == k ? zk : zm; };
  const float2 xk = scaled_bin(zof, gain, tw, k, M, c.row0, K);
  const float2 xr = scaled_bin(zof, gain, tw, k == 0 ? M : M - k, M, c.row0, K);
  z[k] = unsplit_bin(xk, xr, __ldg(tw + k));
  if (k > 0 && M - k != k) z[M - k] = unsplit_bin(xr, xk, __ldg(tw + M - k));
}

__global__ void __launch_bounds__(kFrameThreads)
global_overlap_add(SupIO io, SupConsts c, const float2* Y, long long ys, long long g0, int nf,
                   int n_itiles, const float* tail_in, float* tail_out) {
  const int f = blockIdx.x / n_itiles;
  const int i = (blockIdx.x - f * n_itiles) * kFrameThreads + threadIdx.x;
  const int N = c.n_fft, hop = c.hop, T = c.n_frames;
  if (i >= hop) return;
  const long long g = g0 + f, b = g / T, t = g - b * T;
  const float* const window = io.tables;
  const float inv_n = 1.f / (float)N;
  auto rec = [&](int s, int j) {
    const float2 v = Y[s * ys + (j >> 1)];
    return (j & 1) ? (-v.y * inv_n) * __ldg(window + j) : (v.x * inv_n) * __ldg(window + j);
  };
  const float prev =
      t == 0 ? io.ola[b * (N - hop) + i] : f == 0 ? tail_in[i] : rec(f - 1, hop + i);
  io.y[b * T * hop + t * hop + i] =
      __fmul_rn(__fadd_rn(rec(f, i), prev), __ldg(io.tables + N + i));
  if (t == T - 1) io.o_ola[b * (N - hop) + i] = rec(f, hop + i);
  if (f == nf - 1) tail_out[i] = rec(f, hop + i);
}

// bytes of the global frame pass's scratch: the two chunk buffers of N
// points a frame and the two overlap-add tails
// (models/streaming.py::k8_global_scratch_bytes)
long long global_scratch_bytes(int N, long long frames, int hop) {
  return 16LL * N * chunk_frames(N, frames) + 8LL * hop;
}

cudaError_t launch_frames_global(const SupIO& io, const SupConsts& c, cudaStream_t s) {
  const int M = c.n_fft / 2, hop = c.hop, N = c.chirp_n ? c.chirp_n : M;
  const FourStep fs = four_step_of(N);
  const long long frames = (long long)c.n_frames * c.n_streams;
  const long long chunk = chunk_frames(N, frames);
  if (!fs.ok || io.frame_scratch == nullptr ||
      global_scratch_bytes(N, frames, hop) > io.frame_scratch_bytes)
    return cudaErrorInvalidValue;
  float2* const A = reinterpret_cast<float2*>(io.frame_scratch);
  float2* const B = A + chunk * N;
  float* const tails = reinterpret_cast<float*>(B + chunk * N);
  auto f2 = [](const float* p) { return reinterpret_cast<const float2*>(p); };
  const float2* const chirp = c.chirp_n ? f2(io.chirp) : nullptr;
  const float2* const table =
      c.chirp_n ? f2(io.chirp_tab) : f2(io.tables + twiddle_offset(c.n_fft, hop));
  const int tn = c.chirp_n ? N : c.n_fft;
  const int n_ktiles = (M / 2 + kFrameThreads) / kFrameThreads;
  const int n_itiles = (hop + kFrameThreads - 1) / kFrameThreads;
  int parity = 0;
  for (long long g0 = 0; g0 < frames; g0 += chunk, parity ^= 1) {
    const int nf = (int)(frames - g0 < chunk ? frames - g0 : chunk);
    if ((long long)nf * (n_ktiles > n_itiles ? n_ktiles : n_itiles) > 0x7fffffffLL)
      return cudaErrorInvalidValue;
    const Source frame{Source::kEvenFrame, io.xa, io.xa_len, g0, c.n_frames, hop, 0, io.tables,
                       nullptr, 0, nullptr, M};
    cudaError_t err = transform_chunk(frame, A, B, table, tn, chirp, f2(io.chirp_bt), M, true, fs,
                                      nf, s);
    if (err != cudaSuccess) return err;
    global_split_gain<<<nf * n_ktiles, kFrameThreads, 0, s>>>(io, c, B, N, g0, n_ktiles);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const Source mid{Source::kBuffer, nullptr, 0, 0, 1, 0, 0, nullptr, B, N, nullptr, M};
    err = transform_chunk(mid, A, B, table, tn, chirp, f2(io.chirp_bt), M, true, fs, nf, s);
    if (err != cudaSuccess) return err;
    global_overlap_add<<<nf * n_itiles, kFrameThreads, 0, s>>>(
        io, c, B, N, g0, nf, n_itiles, tails + (parity ^ 1) * hop, tails + parity * hop);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// B''. the DFT frame pass
// ---------------------------------------------------------------------------

constexpr int kDftFpt = 4;  // frames a thread sums at once

// shared bytes of a DFT frame-pass block holding `slots` frames: the windowed
// frames (then their inverses) | the spectra | the twiddles | the gains
__host__ __device__ inline int dft_frame_smem(int n_fft, int K, int slots) {
  return 4 * n_fft * slots + 8 * (n_fft / 2 + 1) * slots + 8 * n_fft + 4 * slots * K;
}

// the most slots (a multiple of kDftFpt, at most 16, at least 4) that fit
int dft_slots(int n_fft, int K) {
  for (int slots = 16; slots >= kDftFpt; slots -= kDftFpt)
    if (dft_frame_smem(n_fft, K, slots) <= kSmemLimit) return slots;
  return 0;
}

__global__ void __launch_bounds__(kFrameThreads)
suppressor_frames_dft(SupIO io, SupConsts c, int slots, int n_tiles) {
  extern __shared__ float4 smem4[];
  constexpr int FPT = kDftFpt;
  const int N = c.n_fft, hop = c.hop, M = N / 2, K = c.K, T = c.n_frames;
  const int b = blockIdx.x / n_tiles;
  const int FT = slots - 1;
  const int t0 = (blockIdx.x - b * n_tiles) * FT;
  float* const xs = reinterpret_cast<float*>(smem4);  // [N][slots], then rec [slots][N]
  float* const rec = xs;
  float2* const X = reinterpret_cast<float2*>(xs + N * slots);  // [M + 1][slots]
  float2* const tw = X + (M + 1) * slots;                       // [N]
  float* const gains = reinterpret_cast<float*>(tw + N);        // [slots][K]
  const float* const window = io.tables;
  const float* const inv_ws = io.tables + N;
  const float2* const twg = reinterpret_cast<const float2*>(io.tables + twiddle_offset(N, hop));
  const int tid = threadIdx.x;

  // ---- stage the tile's windowed frames (slot s: frame t0 - 1 + s), the
  // twiddles and the gains ----
  const float* const xrow = io.xa + (long long)b * io.xa_len;
  for (int i = tid; i < slots * N; i += kFrameThreads) {
    const int sl = i / N, m = i - sl * N;
    const long long s = (long long)(t0 - 1 + sl) * hop + m;
    const float v = (s >= 0 && s < io.xa_len) ? xrow[s] : 0.f;
    xs[m * slots + sl] = v * __ldg(window + m);
  }
  for (int i = tid; i < N; i += kFrameThreads) tw[i] = twg[i];
  const float* const grow = io.gain + (long long)b * K * T;
  for (int i = tid; i < slots * K; i += kFrameThreads) {
    const int k = i / slots, sl = i - k * slots;
    const int t = t0 - 1 + sl;
    gains[sl * K + k] = (t >= 0 && t < T) ? grow[(long long)k * T + t] : 0.f;
  }
  __syncthreads();

  // ---- forward: X[k] of every slot, the band rows scaled by the gain ----
  const int groups = slots / FPT;
  for (int u = tid; u < (M + 1) * groups; u += kFrameThreads) {
    const int g = u / (M + 1), k = u - g * (M + 1);
    float re[FPT], im[FPT];
    dft_forward<FPT>(xs, slots, g * FPT, tw, N, k, re, im);
    const int kb = k - c.row0;
    const bool band = kb >= 0 && kb < K;
#pragma unroll
    for (int f = 0; f < FPT; ++f) {
      const int sl = g * FPT + f;
      float2 v = make_float2(re[f], im[f]);
      if (band) {
        const float gv = gains[sl * K + kb];
        v = make_float2(__fmul_rn(v.x, gv), __fmul_rn(v.y, gv));
      }
      X[k * slots + sl] = v;
    }
  }
  __syncthreads();  // every read of the frames is done: their place takes the inverses

  // ---- inverse: the windowed inverse of every live slot; at frame 0 the
  // carried tail in slot 0's second half ----
  const float inv_n = 1.f / (float)N;
  for (int u = tid; u < N * groups; u += kFrameThreads) {
    const int g = u / N, m = u - g * N;
    float y[FPT];
    dft_inverse_real<FPT>(X, slots, g * FPT, tw, N, m, y);
#pragma unroll
    for (int f = 0; f < FPT; ++f) {
      const int sl = g * FPT + f;
      const int tf = t0 - 1 + sl;
      if (tf >= 0 && tf < T) rec[sl * N + m] = (y[f] * inv_n) * __ldg(window + m);
    }
  }
  if (t0 == 0)
    for (int i = tid; i < N - hop; i += kFrameThreads) rec[hop + i] = io.ola[(long long)b * (N - hop) + i];
  __syncthreads();

  // ---- the overlap-add of frames t0 .. t0 + nf - 1: one run of y ----
  const int nf = min(FT, T - t0);
  float* const yb = io.y + (long long)b * T * hop + (long long)t0 * hop;
  for (int i = tid; i < nf * hop; i += kFrameThreads) {
    const int f = i / hop, n = i - f * hop;  // frame t0 + f is slot f + 1
    yb[i] = __fmul_rn(__fadd_rn(rec[(f + 1) * N + n], rec[f * N + hop + n]), __ldg(inv_ws + n));
  }
  if (t0 + FT >= T) {  // frame T - 1 is here: its tail is the next chunk's
    const float* const last = rec + (T - t0) * N + hop;
    for (int i = tid; i < N - hop; i += kFrameThreads) io.o_ola[(long long)b * (N - hop) + i] = last[i];
  }
}

template <int M>
cudaError_t launch_frames(const SupIO& io, const SupConsts& c, const Plan& p, cudaStream_t s) {
  static int dev_set = -1, smem_set = 0;
  auto kernel = suppressor_frames<M>;
  const cudaError_t err = raise_smem_to((const void*)kernel, p.frame_smem, dev_set, smem_set);
  if (err != cudaSuccess) return err;
  const int n_tiles = (c.n_frames + p.slots - 2) / (p.slots - 1);
  if ((long long)n_tiles * c.n_streams > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<n_tiles * c.n_streams, kFrameThreads, p.frame_smem, s>>>(io, c, p.slots, n_tiles);
  return cudaGetLastError();
}

template <typename Kernel, typename... Args>
cudaError_t launch_walk_with(Kernel kernel, const WalkPlan& w, int n_streams, cudaStream_t s,
                             int& dev_set, int& smem_set, Args... args) {
  const cudaError_t err = raise_smem_to((const void*)kernel, w.smem, dev_set, smem_set);
  if (err != cudaSuccess) return err;
  kernel<<<n_streams, w.threads, w.smem, s>>>(args...);
  return cudaGetLastError();
}

cudaError_t launch_walk(const SupIO& io, const SupConsts& c, const WalkPlan& w, cudaStream_t s) {
  static int dev1 = -1, smem1 = 0, dev4 = -1, smem4 = 0, dev2 = -1, smem2 = 0, devf = -1, smemf = 0;
  const int B = c.n_streams;
  if (w.narrow) return launch_walk_with(suppressor_walk, w, B, s, dev1, smem1, io, c);
  switch (w.frames) {
    case 4:
      return launch_walk_with(suppressor_walk_wide<4>, w, B, s, dev4, smem4, io, c, w.bpt, 0LL);
    case 2:
      return launch_walk_with(suppressor_walk_wide<2>, w, B, s, dev2, smem2, io, c, w.bpt, 0LL);
    default:
      return launch_walk_with(suppressor_walk_wide<1>, w, B, s, devf, smemf, io, c, w.bpt,
                              w.scratch);
  }
}

template <int kW>
cudaError_t launch_frames_mixed(const SupIO& io, const SupConsts& c, const MixedPlan& plan,
                                cudaStream_t s) {
  static int dev_set = -1, smem_set = 0;
  const int slots = mixed_slots(c.n_fft, c.K);
  if (slots == 0) return cudaErrorInvalidValue;
  const int smem = mixed_frame_smem(c.n_fft, c.K, slots);
  auto kernel = suppressor_frames_mixed<kW>;
  const cudaError_t err = raise_smem_to((const void*)kernel, smem, dev_set, smem_set);
  if (err != cudaSuccess) return err;
  int lg = 0;
  while ((1 << lg) < slots) ++lg;
  const int n_tiles = (c.n_frames + slots - 2) / (slots - 1);
  if ((long long)n_tiles * c.n_streams > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<n_tiles * c.n_streams, kFrameThreads, smem, s>>>(io, c, lg, n_tiles, plan);
  return cudaGetLastError();
}

cudaError_t launch_frames_dft(const SupIO& io, const SupConsts& c, cudaStream_t s) {
  static int dev_set = -1, smem_set = 0;
  const int slots = dft_slots(c.n_fft, c.K);
  if (slots == 0) return cudaErrorInvalidValue;
  const int smem = dft_frame_smem(c.n_fft, c.K, slots);
  const cudaError_t err =
      raise_smem_to((const void*)suppressor_frames_dft, smem, dev_set, smem_set);
  if (err != cudaSuccess) return err;
  const int n_tiles = (c.n_frames + slots - 2) / (slots - 1);
  if ((long long)n_tiles * c.n_streams > 0x7fffffffLL) return cudaErrorInvalidValue;
  suppressor_frames_dft<<<n_tiles * c.n_streams, kFrameThreads, smem, s>>>(io, c, slots, n_tiles);
  return cudaGetLastError();
}

cudaError_t launch_frames_chirpz(const SupIO& io, const SupConsts& c, cudaStream_t s) {
  static int dev_set = -1, smem_set = 0;
  const int slots = chirpz_slots(c.chirp_n, c.K);
  const MixedPlan plan = mixed_plan_of(c.chirp_n);
  if (slots == 0) return cudaErrorInvalidValue;
  const int smem = chirpz_frame_smem(c.chirp_n, c.K, slots);
  const cudaError_t err =
      raise_smem_to((const void*)suppressor_frames_chirpz, smem, dev_set, smem_set);
  if (err != cudaSuccess) return err;
  int lg = 0;
  while ((1 << lg) < slots) ++lg;
  const int n_tiles = (c.n_frames + slots - 2) / (slots - 1);
  if ((long long)n_tiles * c.n_streams > 0x7fffffffLL) return cudaErrorInvalidValue;
  suppressor_frames_chirpz<<<n_tiles * c.n_streams, kFrameThreads, smem, s>>>(io, c, lg, n_tiles,
                                                                               plan);
  return cudaGetLastError();
}

// the FFT frame pass takes a power of two from kMinFft to kMaxFft
bool fft_route(int n_fft) {
  return n_fft >= kMinFft && n_fft <= kMaxFft && (n_fft & (n_fft - 1)) == 0;
}

}  // namespace

// One chunk of B streams; see SupIO and SupConsts.  `route` is the frame
// pass, chosen by the caller from the geometry (models/streaming.py::
// k8_route): 0 the FFT pass (a power-of-two n_fft from 64 to 1024), 1 the
// mixed pass (an n_fft whose half has a plan, mixed_plan_of), 2 the DFT
// pass (any n_fft whose tile fits; comparisons only), 3 the chirp-z pass
// (over chirp_n points, chirp_size_takes(n_fft / 2, n_fft / 2, chirp_n):
// every bin is wanted), 4 the global pass (the four-step
// transform of n_fft / 2 points, or of chirp_n with the chirp-z tables).
// Refuses what the kernels do not take (models/streaming.py::
// k8_check_geometry says the same): n_fft not 2 hop, band bins outside the
// spectrum, more SNR columns than band bins, a route that does not take
// n_fft, a tile or scratch that does not fit.
// (The structures are passed as untyped pointers: a function whose
// parameter types lie in an unnamed namespace gets internal linkage.)
extern "C" int apt_streaming_suppressor(const void* io_ptr, const void* c_ptr, int route,
                                        void* stream) {
  const SupIO* io = static_cast<const SupIO*>(io_ptr);
  const SupConsts* c = static_cast<const SupConsts*>(c_ptr);
  const int N = c->n_fft, M = N / 2;
  if (N < 2 || c->hop * 2 != N || c->K < 1 || c->row0 < 0 || c->row0 + c->K > M + 1 ||
      c->n_taps < 0 || (c->n_taps > 0 && io->taps == nullptr) || c->n_snr < 0 ||
      c->n_snr > c->K || c->n_frames < 1 || c->n_streams < 1 || io->gain == nullptr ||
      c->chirp_n < 0)
    return (int)cudaErrorInvalidValue;
  const MixedPlan mixed = mixed_plan_of(M);
  const bool chirp_ok = c->chirp_n == 0 ? mixed.n_pass > 0
                                        : chirp_size_takes(M, M, c->chirp_n) &&
                                              io->chirp != nullptr && io->chirp_bt != nullptr &&
                                              io->chirp_tab != nullptr;
  bool takes = false;
  switch (route) {
    case 0: takes = fft_route(N) && plan_for(*c).frame_smem <= kSmemLimit; break;
    case 1: takes = mixed.n_pass > 0 && mixed_slots(N, c->K) > 0; break;
    case 2: takes = dft_slots(N, c->K) > 0; break;
    case 3: takes = c->chirp_n > 0 && chirp_ok && chirpz_slots(c->chirp_n, c->K) > 0; break;
    case 4: takes = chirp_ok; break;  // launch_frames_global checks the split and the scratch
    default: break;
  }
  const WalkPlan w = walk_plan(*c);
  if (!takes || (w.scratch > 0 && (io->walk_scratch == nullptr ||
                                   w.scratch * c->n_streams > io->walk_scratch_floats)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = launch_walk(*io, *c, w, s);
  if (err != cudaSuccess) return (int)err;
  switch (route) {
    case 1:
      return (int)by_width(mixed, [&](auto w) {
        return launch_frames_mixed<decltype(w)::value>(*io, *c, mixed, s);
      });
    case 2: return (int)launch_frames_dft(*io, *c, s);
    case 3: return (int)launch_frames_chirpz(*io, *c, s);
    case 4: return (int)launch_frames_global(*io, *c, s);
    default: break;
  }
  const Plan p = plan_for(*c);
  switch (N) {
    case 64: return (int)launch_frames<32>(*io, *c, p, s);
    case 128: return (int)launch_frames<64>(*io, *c, p, s);
    case 256: return (int)launch_frames<128>(*io, *c, p, s);
    case 512: return (int)launch_frames<256>(*io, *c, p, s);
    default: return (int)launch_frames<512>(*io, *c, p, s);
  }
}
