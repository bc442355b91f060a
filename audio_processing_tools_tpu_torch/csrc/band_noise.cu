// K6: the band-noise estimator's per-frame scan, hand-written for Hopper
// (sm_90a).
//
// It replaces `_run_band_scan` (audio_processing_tools_tpu/models/
// band_noise.py:358-624), the `lax.scan` over frames of the firmware
// estimator: per frame the FFT rain decision from band-sum jumps, the S
// subframe dB-rise steps with their hold, the TTL expiry of the W-slot ring
// buffer of noise energies, the pushes of the frame's noise subframes (and
// the replenish), the adaptive quantile, the rank-selected quantile of the
// buffer and its EMA, the N_E smoothing, the telemetry accumulators and the
// Wiener gain.  Every configuration branch is a constant of the launch.
//
// What bounds it on this card.  At band noise's batch (128 clips x 218
// frames) it reads 10 values a frame and writes ~25 (S = 4): ~4 MB, about
// 1 us at 3.35 TB/s.  The bound is the chain: a frame waits for the last, and
// its dependent path (four subframe log10 steps, the rank count over the
// ring, the EMA, the gain) is a few hundred instructions, so 218 frames take
// tens of microseconds whatever the card's width.
//
// Design: one warp per lane (clip or stream), one lane per block.  Thread j
// owns ring slot j (and j + 32 when W > 32) in registers: value, valid flag,
// frame index.  The scalar work of a frame runs the same on every thread
// (uniform branches, no divergence); the expiry and the pushes are
// per-thread selects; the rank of a slot is a count over W shuffles, an
// integer, so its order does not matter; the two order statistics are a
// ballot for the thread holding each rank and a shuffle of its value, which
// is the value the JAX masked sum picks.  The next frame's inputs are loaded
// while this frame is walked.  Thread 0 writes the outputs.
//
// Arithmetic follows the plain loop (models/band_noise.py::_band_scan_plain)
// step for step: every product, sum and quotient is rounded on its own
// (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn, never contracted into an
// FMA), log10f and sqrtf are the IEEE library functions PyTorch's kernels
// call, constants arrive rounded to float by the host as the JAX program
// rounds them, and max/min propagate NaN as jnp.maximum/minimum do.  So the
// kernel gives the plain loop's bits wherever they are numbers.

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr int kMaxS = 8;         // subframes per frame
constexpr unsigned kFull = 0xffffffffu;
// carry and output layouts (models/band_noise.py::_CARRY_F, _CARRY_I,
// _OUT_F, _OUT_I)
constexpr int kCF = 11, kCI = 15, kOF = 9, kOI = 10;

struct BandConsts {
  float M_ratio, N_ratio, D_ratio, eps12, min_Ehpf, min_Eband, band_rise_db, excess_rise_db,
      dE_thr;
  int hold_k, use_dE, use_D, ttl, W, W_min, learn_all, replenish, replenish_not_full, rq_lo, rq_hi;
  float rq_frac, eps;
  int q_adapt;
  float ra_keep, ra_add, na_keep, na_add, q_min, q_max, ema_keep, ema_a, S_f;
  int smooth;
  float wet, dry, release, beta, gain_floor;
  int S, B, T;
};

struct BandIO {
  const float *subE, *subEhpf, *rain_sum, *primary, *Eb, *Mb;
  const float* cf;
  const int* ci;
  const float* buf;
  const uint8_t* valid;
  const int* bidx;
  float* o_cf;
  int* o_ci;
  float* o_buf;
  uint8_t* o_valid;
  int* o_bidx;
  float* of;
  int* oi;
  uint8_t* om;
};

__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
// torch.clamp(x, lo, hi): NaN stays NaN
__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return min_nan(max_nan(x, lo), hi);
}
// v_lo + frac (v_hi - v_lo)
__device__ __forceinline__ float lerp_rn(float v_lo, float v_hi, float frac) {
  return __fadd_rn(v_lo, __fmul_rn(frac, __fsub_rn(v_hi, v_lo)));
}

struct FrameIn {
  float sE[kMaxS], sEh[kMaxS], rs, pr, Eb, Mb;
};

__device__ __forceinline__ void load_frame(const BandIO& io, const BandConsts& c, int b, int t,
                                           FrameIn& f) {
  if (t >= c.T) return;
  const long long ft = (long long)b * c.T + t;
#pragma unroll
  for (int s = 0; s < kMaxS; ++s) {
    f.sE[s] = s < c.S ? io.subE[ft * c.S + s] : 0.f;
    f.sEh[s] = s < c.S ? io.subEhpf[ft * c.S + s] : 0.f;
  }
  f.rs = io.rain_sum[ft];
  f.pr = io.primary[ft];
  f.Eb = io.Eb[ft];
  f.Mb = io.Mb[ft];
}

// SPL ring slots per thread: slot k * 32 + lane
template <int SPL>
__global__ void __launch_bounds__(32)
band_scan(const BandIO io, const BandConsts c) {
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  const int S = c.S, T = c.T, W = c.W;
  const unsigned all = (1u << S) - 1u;

  const float* cf = io.cf + (long long)b * kCF;
  const int* ci = io.ci + (long long)b * kCI;
  float prev_rain = cf[0], prev_prim = cf[1], prev_Eb = cf[2], prev_Lb = cf[3], prev_Lh = cf[4],
        ema = cf[5], q_eff = cf[6], ne_smooth = cf[7], e_noise = cf[8], e_rain = cf[9],
        e_total = cf[10];
  bool have_fft = ci[0] != 0, have_Eb = ci[1] != 0, have_L = ci[2] != 0;
  int hold = ci[3], wr = ci[4], count_valid = ci[5], fsnu = ci[6], frame_idx = ci[7],
      n_noise = ci[8], n_rain = ci[9], n_total = ci[10], min_valid = ci[11], underflow = ci[12],
      learned_total = ci[13], replenish_total = ci[14];

  float bv[SPL];
  bool vv[SPL];
  int bi[SPL];
#pragma unroll
  for (int k = 0; k < SPL; ++k) {
    const int w = k * 32 + lane;
    const long long g = (long long)b * W + w;
    bv[k] = w < W ? io.buf[g] : 0.f;
    vv[k] = w < W && io.valid[g] != 0;
    bi[k] = w < W ? io.bidx[g] : -1;
  }

  // one value into slot wr when `on` (uniform): band_noise.py::push
  auto push = [&](float v, bool on) {
    if (!on) return;
    const int kk = wr >> 5, owner = wr & 31;
    bool was = false;
#pragma unroll
    for (int k = 0; k < SPL; ++k)
      if (k == kk) was = (__ballot_sync(kFull, vv[k]) >> owner) & 1u;
#pragma unroll
    for (int k = 0; k < SPL; ++k)
      if (k == kk && lane == owner) {
        bv[k] = v;
        vv[k] = true;
        bi[k] = frame_idx;
      }
    if (!was) ++count_valid;
    wr = wr + 1 == W ? 0 : wr + 1;
  };

  FrameIn cur, nxt;
  load_frame(io, c, b, 0, cur);
  for (int t = 0; t < T; ++t) {
    load_frame(io, c, b, t + 1, nxt);
    frame_idx += 1;

    // ---- FFT rain decision ----
    const bool cond1 = cur.rs > __fmul_rn(__fadd_rn(prev_rain, c.eps12), c.M_ratio);
    const bool cond2 = cur.pr > __fmul_rn(__fadd_rn(prev_prim, c.eps12), c.N_ratio);
    const bool fft_rain = have_fft && cond1 && cond2;
    prev_rain = cur.rs;
    prev_prim = cur.pr;
    have_fft = true;

    // ---- time-domain mask over the subframes ----
    unsigned mask = 0;
#pragma unroll
    for (int s = 0; s < kMaxS; ++s) {
      if (s >= S) break;
      const float Eb_s = max_nan(cur.sE[s], c.eps12);
      bool m = hold > 0;
      if (m) hold -= 1;
      const float Eh_s = cur.sEh[s];
      const bool ok = Eh_s >= c.min_Ehpf && Eb_s >= c.min_Eband;
      const float Lb = __fmul_rn(10.f, log10f(__fadd_rn(Eb_s, c.eps12)));
      const float Lh = __fmul_rn(10.f, log10f(__fadd_rn(Eh_s, c.eps12)));
      const float dLb = __fsub_rn(Lb, prev_Lb);
      const float dLh = __fsub_rn(Lh, prev_Lh);
      bool trig = ok && have_L && dLb >= c.band_rise_db && __fsub_rn(dLb, dLh) >= c.excess_rise_db;
      if (ok) {
        prev_Lb = Lb;
        prev_Lh = Lh;
      }
      have_L = ok;
      if (c.use_dE) {
        const float dE = max_nan(__fsub_rn(Eb_s, prev_Eb), 0.f);
        const float metric = __fdiv_rn(dE, __fadd_rn(max_nan(Eh_s, c.eps12), c.eps12));
        trig = trig || (have_Eb && metric >= c.dE_thr);
      }
      if (c.use_D)
        trig = trig || (have_Eb && Eb_s > __fmul_rn(__fadd_rn(prev_Eb, c.eps12), c.D_ratio));
      m = m || trig;
      if (trig) hold = max(hold, c.hold_k);
      prev_Eb = Eb_s;
      have_Eb = true;
      if (m) mask |= 1u << s;
    }
    const unsigned sub = fft_rain ? all : mask;

    // ---- expiry before learning ----
    if (c.ttl > 0) {
      const bool on = count_valid > 0;
      int n_stale = 0;
#pragma unroll
      for (int k = 0; k < SPL; ++k) {
        const bool stale = vv[k] && frame_idx - bi[k] > c.ttl;
        n_stale += __popc(__ballot_sync(kFull, stale));
        if (on && stale) {
          vv[k] = false;
          bv[k] = 0.f;
          bi[k] = -1;
        }
      }
      if (on) count_valid = max(count_valid - n_stale, 0);
    }

    // ---- learning ----
    const unsigned learn = c.learn_all ? all : (~sub & all);
#pragma unroll
    for (int s = 0; s < kMaxS; ++s) {
      if (s >= S) break;
      push(max_nan(cur.sE[s], c.eps), (learn >> s) & 1u);
    }
    const int learned = __popc(learn);
    int replenish = 0;
    if (c.replenish) {
      bool should = learned == 0;
      if (c.replenish_not_full) should = should && count_valid < W;
      if (should) {
        // quantile_linear over the S energies: sorted, then interpolated
        float srt[kMaxS];
#pragma unroll
        for (int s = 0; s < kMaxS; ++s) srt[s] = cur.sE[s];
        for (int i = 1; i < S; ++i) {
          const float v = srt[i];
          int j = i - 1;
          while (j >= 0 && srt[j] > v) {
            srt[j + 1] = srt[j];
            --j;
          }
          srt[j + 1] = v;
        }
        push(max_nan(lerp_rn(srt[c.rq_lo], srt[c.rq_hi], c.rq_frac), c.eps), true);
        replenish = 1;
      }
    }
    learned_total += learned;
    replenish_total += replenish;
    fsnu = learned + replenish > 0 ? 0 : fsnu + 1;

    // ---- adaptive q ----
    if (c.q_adapt) {
      if (replenish > 0) q_eff = __fadd_rn(__fmul_rn(q_eff, c.ra_keep), c.ra_add);
      if (learned > 0) q_eff = __fadd_rn(__fmul_rn(q_eff, c.na_keep), c.na_add);
      q_eff = clamp_nan(q_eff, c.q_min, c.q_max);
    }

    // ---- the buffer's quantile by rank selection ----
    const bool warm = count_valid >= c.W_min;
    float xv[SPL];
    int rank[SPL];
    int count = 0;
#pragma unroll
    for (int k = 0; k < SPL; ++k) {
      xv[k] = vv[k] ? bv[k] : FLT_MAX;
      rank[k] = 0;
      count += __popc(__ballot_sync(kFull, vv[k]));
    }
    for (int src = 0; src < W; ++src) {
      float xs = 0.f;
#pragma unroll
      for (int k = 0; k < SPL; ++k)
        if (k == (src >> 5)) xs = __shfl_sync(kFull, xv[k], src & 31);
#pragma unroll
      for (int k = 0; k < SPL; ++k)
        rank[k] += (xs < xv[k] || (xs == xv[k] && src < k * 32 + lane)) ? 1 : 0;
    }
    const float h = __fmul_rn(q_eff, (float)max(count - 1, 0));
    const int lo = (int)floorf(h), hi = (int)ceilf(h);
    const float frac = __fsub_rn(h, (float)lo);
    float v_lo = 0.f, v_hi = 0.f;
#pragma unroll
    for (int k = 0; k < SPL; ++k) {
      const bool real = k * 32 + lane < W;
      const unsigned at_lo = __ballot_sync(kFull, real && rank[k] == lo);
      const unsigned at_hi = __ballot_sync(kFull, real && rank[k] == hi);
      const float from_lo = __shfl_sync(kFull, xv[k], at_lo ? __ffs(at_lo) - 1 : 0);
      const float from_hi = __shfl_sync(kFull, xv[k], at_hi ? __ffs(at_hi) - 1 : 0);
      if (at_lo) v_lo = from_lo;
      if (at_hi) v_hi = from_hi;
    }
    const float qv = count > 0 ? lerp_rn(v_lo, v_hi, frac) : 0.f;

    // ---- noise scalar (warm-up semantics) ----
    const float ema_new = __fadd_rn(__fmul_rn(c.ema_keep, ema), __fmul_rn(c.ema_a, qv));
    ema = warm ? ema_new : 0.f;
    if (!warm) ne_smooth = 0.f;
    const float n_sub = warm ? ema : 0.f;
    const float ne_raw = __fmul_rn(c.S_f, n_sub);
    float ne = ne_raw;
    const bool any_rain = sub != 0;
    if (c.smooth) {
      const float up = any_rain ? c.wet : c.dry;
      const float alpha = ne_raw > ne_smooth ? up : c.release;
      ne_smooth = __fadd_rn(__fmul_rn(__fsub_rn(1.f, alpha), ne_smooth), __fmul_rn(alpha, ne_raw));
      ne = ne_smooth;
    }

    // ---- telemetry ----
    float rain_e = (sub & 1u) ? cur.sE[0] : 0.f;
    float dry_e = (sub & 1u) ? 0.f : cur.sE[0];
#pragma unroll
    for (int s = 1; s < kMaxS; ++s) {
      if (s >= S) break;
      const bool r = (sub >> s) & 1u;
      rain_e = __fadd_rn(rain_e, r ? cur.sE[s] : 0.f);
      dry_e = __fadd_rn(dry_e, r ? 0.f : cur.sE[s]);
    }
    const float noise_e = min_nan(max_nan(ne, 0.f), max_nan(dry_e, 0.f));
    const int prev_total = n_total;
    e_total = __fadd_rn(e_total, max_nan(cur.Eb, 0.f));
    e_rain = __fadd_rn(e_rain, rain_e);
    e_noise = __fadd_rn(e_noise, noise_e);
    n_total = prev_total + 1;
    min_valid = prev_total == 0 ? count_valid : min(min_valid, count_valid);
    underflow += count_valid < c.W_min;
    n_rain += any_rain;
    n_noise += !any_rain;

    // ---- Wiener gain ----
    const float num = max_nan(__fsub_rn(cur.Eb, __fmul_rn(c.beta, ne)), 0.f);
    const float g_pow = __fdiv_rn(num, __fadd_rn(cur.Eb, c.eps));
    const float g = clamp_nan(__fsqrt_rn(clamp_nan(g_pow, 0.f, 1.f)), c.gain_floor, 1.f);

    if (lane == 0) {
      const long long plane = (long long)c.B * T;
      const long long o = (long long)b * T + t;
      const float fo[kOF] = {ne, ne_raw, g, __fmul_rn(cur.Mb, g), n_sub, e_noise, e_rain, e_total,
                             q_eff};
      const int io_[kOI] = {fft_rain, n_noise, n_rain, n_total, count_valid, min_valid, underflow,
                            fsnu, learned_total, replenish_total};
#pragma unroll
      for (int i = 0; i < kOF; ++i) io.of[i * plane + o] = fo[i];
#pragma unroll
      for (int i = 0; i < kOI; ++i) io.oi[i * plane + o] = io_[i];
      for (int s = 0; s < S; ++s) io.om[o * S + s] = (sub >> s) & 1u;
    }
    cur = nxt;
  }

  // ---- the carry after the last frame ----
#pragma unroll
  for (int k = 0; k < SPL; ++k) {
    const int w = k * 32 + lane;
    if (w < W) {
      const long long g = (long long)b * W + w;
      io.o_buf[g] = bv[k];
      io.o_valid[g] = vv[k];
      io.o_bidx[g] = bi[k];
    }
  }
  if (lane == 0) {
    const float fo[kCF] = {prev_rain, prev_prim, prev_Eb, prev_Lb, prev_Lh, ema, q_eff, ne_smooth,
                           e_noise, e_rain, e_total};
    const int io_[kCI] = {have_fft, have_Eb, have_L, hold, wr, count_valid, fsnu, frame_idx,
                          n_noise, n_rain, n_total, min_valid, underflow, learned_total,
                          replenish_total};
#pragma unroll
    for (int i = 0; i < kCF; ++i) io.o_cf[(long long)b * kCF + i] = fo[i];
#pragma unroll
    for (int i = 0; i < kCI; ++i) io.o_ci[(long long)b * kCI + i] = io_[i];
  }
}

}  // namespace

// io: BandIO, consts: BandConsts (models/band_noise.py::_BandIO,
// _BandConsts); 1 <= S <= 8, S <= W <= 64, B >= 1, T >= 0.
extern "C" int apt_band_noise_scan(const void* io_ptr, const void* consts_ptr, void* stream) {
  const BandIO& io = *static_cast<const BandIO*>(io_ptr);
  const BandConsts& c = *static_cast<const BandConsts*>(consts_ptr);
  if (c.S < 1 || c.S > kMaxS || c.W < c.S || c.W > 64 || c.B < 1 || c.T < 0 || c.rq_lo < 0 ||
      c.rq_hi >= c.S)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (c.W <= 32)
    band_scan<1><<<c.B, 32, 0, st>>>(io, c);
  else
    band_scan<2><<<c.B, 32, 0, st>>>(io, c);
  return (int)cudaGetLastError();
}
