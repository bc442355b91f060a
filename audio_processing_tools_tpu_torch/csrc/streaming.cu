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
// two launches on the caller's stream:
//
//  A. the walk: one block per stream, one thread per band bin (as many warps
//     as the K band bins need), walks the frames in order with the
//     tracker, the SNR gate, the gain and the EMA, and writes the clipped
//     gain G (B, K, T) and the carries.  It reads only the band power K1
//     computed, the classes and the confidences, a round ahead.  A round
//     is kFrames frames between two barriers: the tracker steps and the
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
//     the block holding frame T - 1 writes the new tail.  It takes n_fft
//     from 64 to 1024, as K1 does, which computes the band power the walk
//     reads (below 64 a group of n_fft / 16 threads would be under 4).
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

#include "stockham_fft.cuh"

namespace {

constexpr int kMaxTaps = 9;
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
  int n_taps;  // 0: no frequency smoothing
  float taps[kMaxTaps];
  float alpha_base, one_minus_alpha_base;
  // geometry: n_fft = 2 hop; band bins row0 .. row0 + K - 1
  int n_fft, hop, K, row0, n_frames, n_streams;
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
  const float* tables;        // w (n_fft) | 1 / sum w^2 (hop) | e^{-2 pi i k / n_fft} (n_fft pairs)
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
};

__host__ __device__ inline int pow2_at_least(int n) {
  int m = 1;
  while (m < n) m *= 2;
  return m;
}

// The launch plan of a geometry.
struct Plan {
  int walk_threads, walk_smem, slots, frame_smem;
};

Plan plan_for(const SupConsts& c) {
  const int M = c.n_fft / 2, pad = c.n_taps / 2;
  const int fpr = kFrameThreads / (M / 8);  // frames a round of the frame pass
  Plan p;
  p.walk_threads = 32 * ((c.K + 31) / 32);
  // per frame of a round: the padded gain row twice, P and N_eff per band
  // bin, the two SNR trees
  p.walk_smem = 4 * kFrames * (2 * (c.K + 2 * pad) + 2 * c.K + 2 * pow2_at_least(c.n_snr));
  p.slots = fpr >= kMinSlots ? fpr : kMinSlots;
  // exchange buffers | samples | frames | gains | Nyquist bins
  p.frame_smem = 4 * (2 * fpr * (M + 8) + (p.slots - 1) * c.hop + c.n_fft + p.slots * c.n_fft +
                      p.slots * c.K + fpr);
  return p;
}

// ---------------------------------------------------------------------------
// A. the walk
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kMaxWalkThreads) suppressor_walk(SupIO io, SupConsts c) {
  extern __shared__ float sm[];
  constexpr int F = kFrames;
  const int K = c.K, T = c.n_frames, pad = c.n_taps / 2, m = pow2_at_least(c.n_snr);
  const int grow = K + 2 * pad;
  float* const sG = sm;                // [2][F][pad zeros | K gains | pad zeros], by round parity
  float* const sP = sG + 2 * F * grow;  // [F][K]
  float* const sNe = sP + F * K;        // [F][K]
  float* const red = sNe + F * K;       // [F][2][m]

  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < 2 * F * pad; i += nt) {
    const int r = i / pad, j = i - r * pad;
    sG[r * grow + j] = sG[r * grow + pad + K + j] = 0.f;
  }

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

    // ---- the PSD steps and N_eff, frame after frame (band bin tid) ----
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const bool live = f < nf;
      const bool rain = ca[f] != 0;
      const float pt = pa[f];
      seed[f] = frame0 + t0 + f == 0;
      const bool allow = (wcount < c.warmup_need) || !rain;
      const float err = __fsub_rn(pt, tracker);
      const float scale_new = __fadd_rn(__fmul_rn(c.scale_alpha, scale),
                                        __fmul_rn(c.one_minus_scale_alpha, fabsf(err)));
      const float step = __fmul_rn(c.eta, nan_max(scale_new, c.step_floor));
      const float q_eff = clamp(__fsub_rn(c.q, __fmul_rn(c.q_minus_aq_min, rain_ema)), c.aq_min, c.q);
      const float up = c.adaptive_q ? q_eff : c.q;
      const float down = c.adaptive_q ? -__fsub_rn(1.f, q_eff) : c.neg_one_minus_q;
      const float delta = __fmul_rn((pt >= tracker) ? up : down, step);
      const float candidate = nan_max(__fadd_rn(tracker, delta), 0.f);
      const float tracker_new = (first || !allow) ? tracker : candidate;
      const float scale_out = first ? scale : scale_new;
      const bool rising = tracker_new > prev_n;
      const float n_ema = __fadd_rn(__fmul_rn(rising ? c.ema_up : c.ema_down, prev_n),
                                    __fmul_rn(rising ? one_minus_up : one_minus_down, tracker_new));
      float n = first ? tracker_new : n_ema;
      n = nan_max(nan_min(n, __fmul_rn(c.track_maxr, pt)), 0.f);
      const float n_used = (c.use_lagged && !seed[f]) ? prev_n : n;
      n_eff[f] = nan_min(n_used, __fmul_rn(c.maxr, pt));
      if (live) {
        tracker = tracker_new;
        scale = scale_out;
        prev_n = n;
        wcount += allow ? 1 : 0;
        rain_ema = __fadd_rn(__fmul_rn(c.aq_alpha, rain_ema),
                             __fmul_rn(c.one_minus_aq_alpha, rain ? 1.f : 0.f));
        first = false;
      }
      gate[f] = 0.f;
    }

    // ---- the SNR gates: per frame the two sums as a tree, element i + h
    // onto i, the round's frames side by side ----
    if (gated) {
      if (lane) {
#pragma unroll
        for (int f = 0; f < F; ++f) {
          sP[f * K + tid] = pa[f];
          sNe[f * K + tid] = n_eff[f];
        }
      }
      __syncthreads();
      for (int i = tid; i < F * m; i += nt) {
        const int f = i / m, j = i - f * m;
        const bool in = j < c.n_snr;
        const int col = in ? __ldg(io.snr_cols + j) : 0;
        red[2 * f * m + j] = in ? sP[f * K + col] : 0.f;
        red[2 * f * m + m + j] = in ? sNe[f * K + col] : 0.f;
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

    // ---- gain_freq_stage: the raw gains, the round's frames independent ----
    float ncc[F], over[F], alpha[F];
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
    float* const sGr = sG + (round & 1) * F * grow;
    float g[F];
    if (c.wiener) {
#pragma unroll
      for (int f = 0; f < F; ++f)
        g[f] = __fdiv_rn(nan_max(__fsub_rn(pa[f], __fmul_rn(over[f], n_eff[f])), 0.f),
                         __fadd_rn(pa[f], c.eps));
    } else {
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const float ratio = clamp(__fdiv_rn(n_eff[f], __fadd_rn(pa[f], c.eps)), 0.f, 1.f);
        g[f] = __fsub_rn(1.f, __fmul_rn(over[f], __fsqrt_rn(ratio)));
      }
    }
    if (lane) {
#pragma unroll
      for (int f = 0; f < F; ++f) sGr[f * grow + pad + tid] = clamp(g[f], c.gain_floor, c.gain_ceil);
    }
    __syncthreads();

    // ---- smoothing over frequency (frames independent), then the EMA over
    // time, frame after frame ----
    float gf[F];
#pragma unroll
    for (int f = 0; f < F; ++f) gf[f] = sGr[f * grow + pad + kk];
    if (c.n_taps > 0) {
      float conv[F];
#pragma unroll
      for (int f = 0; f < F; ++f) conv[f] = 0.f;
      for (int i = 0; i < c.n_taps; ++i) {
#pragma unroll
        for (int f = 0; f < F; ++f)
          conv[f] = __fadd_rn(conv[f], __fmul_rn(c.taps[i], sGr[f * grow + kk + i]));
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
        if (lane) grow_out[t0 + f] = clamp(gt, c.gain_floor, c.gain_ceil);
      }
    }
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
  const float2* const tw = reinterpret_cast<const float2*>(io.tables + N + hop);
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

// Let `kernel` take `bytes` of dynamic shared memory on the current device;
// `dev_set` and `smem_set` remember what was set last, per kernel.
cudaError_t allow_smem(const void* kernel, int bytes, int& dev_set, int& smem_set) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev == dev_set && bytes <= smem_set)) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) {
    dev_set = dev;
    smem_set = bytes;
  }
  return err;
}

template <int M>
cudaError_t launch_frames(const SupIO& io, const SupConsts& c, const Plan& p, cudaStream_t s) {
  static int dev_set = -1, smem_set = 0;
  auto kernel = suppressor_frames<M>;
  const cudaError_t err = allow_smem((const void*)kernel, p.frame_smem, dev_set, smem_set);
  if (err != cudaSuccess) return err;
  const int n_tiles = (c.n_frames + p.slots - 2) / (p.slots - 1);
  if ((long long)n_tiles * c.n_streams > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<n_tiles * c.n_streams, kFrameThreads, p.frame_smem, s>>>(io, c, p.slots, n_tiles);
  return cudaGetLastError();
}

}  // namespace

// One chunk of B streams; see SupIO and SupConsts.  Refuses what the
// kernels do not take (models/streaming.py::k8_check_geometry says the
// same): n_fft not a power of two from 64 to 1024 or not 2 hop, band bins
// outside the spectrum, more than 9 taps, more SNR columns than band bins.
// (The structures are passed as untyped pointers: a function whose
// parameter types lie in an unnamed namespace gets internal linkage.)
extern "C" int apt_streaming_suppressor(const void* io_ptr, const void* c_ptr, void* stream) {
  const SupIO* io = static_cast<const SupIO*>(io_ptr);
  const SupConsts* c = static_cast<const SupConsts*>(c_ptr);
  const int N = c->n_fft;
  if (N < kMinFft || N > kMaxFft || (N & (N - 1)) || c->hop * 2 != N || c->K < 1 || c->row0 < 0 ||
      c->row0 + c->K > N / 2 + 1 || c->n_taps < 0 || c->n_taps > kMaxTaps || c->n_snr < 0 ||
      c->n_snr > c->K || c->n_frames < 1 || c->n_streams < 1 || io->gain == nullptr)
    return (int)cudaErrorInvalidValue;
  const Plan p = plan_for(*c);
  if (p.walk_threads > kMaxWalkThreads || p.walk_smem > kSmemLimit || p.frame_smem > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  static int dev_set = -1, smem_set = 0;
  cudaError_t err = allow_smem((const void*)suppressor_walk, p.walk_smem, dev_set, smem_set);
  if (err != cudaSuccess) return (int)err;
  suppressor_walk<<<c->n_streams, p.walk_threads, p.walk_smem, s>>>(*io, *c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  switch (N) {
    case 64: return (int)launch_frames<32>(*io, *c, p, s);
    case 128: return (int)launch_frames<64>(*io, *c, p, s);
    case 256: return (int)launch_frames<128>(*io, *c, p, s);
    case 512: return (int)launch_frames<256>(*io, *c, p, s);
    default: return (int)launch_frames<512>(*io, *c, p, s);
  }
}
