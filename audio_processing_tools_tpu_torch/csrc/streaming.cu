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
//   S_hat = S with the band rows scaled, a real inverse DFT, the window, the
//   carried half-frame of the overlap-add and the 1 / sum(w^2) factor,
//
// and carries (PSD tracker, G, overlap-add tail) from one chunk to the next.
// Eager PyTorch would launch some 40 small kernels for each frame, ~7,000
// for a 2 s chunk of 174 frames.
//
// What bounds it on this card: the chain of frames.  Frame t + 1's gain
// needs frame t's (the EMA), and its tracker frame t's tracker, so a stream
// is one serial walk.  Bytes are small (64 streams x 2 s: 5.7 MB of samples
// and 3.2 MB of band power in, 5.7 MB of audio out, 4.4 us at 3.35 TB/s);
// the DFTs are 2 x 129 x 256 multiply-adds per frame, 0.74 GFLOP per chunk,
// 11 us at 67 TFLOP/s.  The time is the walk: per frame a few block-wide
// barriers and two DFTs of a few hundred dependent steps per thread.
//
// Design, simple first: one block of 256 threads per stream walks the
// chunk's frames in order; thread k holds band bin k's carry in registers.
// Per frame: the windowed frame into shared memory, the tracker and N_eff
// per band bin, a direct forward real DFT (thread j sums bin j over the
// frame, from a table of cos and sin built in float64 and rounded to
// float), the SNR sums as a tree in shared memory, the gain per band bin
// (its neighbours through shared memory for the smoothing), the scaled band
// bins, then the direct inverse DFT (thread n sums sample n over the bins)
// and the overlap-add.  The forward DFT is the kernel's own, so no library
// FFT, whose algorithm may change with the batch shape, sits on the path.
// At 64 streams the grid fills 64 of the card's 132 SMs.
//
// Arithmetic.  The tracker, the gain and the SNR sums follow the plain loop
// (models/streaming.py::_suppressor_plain) operation for operation: every
// product, sum and quotient rounded on its own (__fmul_rn, __fadd_rn,
// __fsub_rn, __fdiv_rn, __fsqrt_rn, never contracted into an FMA), the SNR
// sums in the fixed tree order of the plain loop, NaN propagated by max and
// min; so the gain and the carries are the plain loop's bits.  The DFTs are
// float sums in an order of their own (the plain loop uses torch.fft), so the
// audio agrees with it to float rounding.  Each frame's arithmetic is the
// same wherever a chunk starts, so the output does not depend on how the
// stream is cut into chunks, nor on how many streams share a launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTaps = 9;
constexpr int kMaxFft = 1024;

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
  const float* tables;        // w (n_fft) | 1 / sum w^2 (hop) | cos (n_fft) | sin (n_fft)
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
  float *o_g_prev, *o_ola;
  float* g_out;  // (B, K, T) clipped gain per frame, or null
};

__host__ __device__ inline int pow2_at_least(int n) {
  int m = 1;
  while (m < n) m *= 2;
  return m;
}

// floats of shared memory: cos, sin, window, frame (n_fft each), 1/sum w^2
// (hop), the spectrum (2 F), the padded gain row, P and N_eff per band bin,
// the two SNR trees, two overlap-add tails
__host__ __device__ inline int smem_floats(const SupConsts& c) {
  const int F = c.n_fft / 2 + 1, pad = c.n_taps / 2;
  return 4 * c.n_fft + c.hop + 2 * F + (c.K + 2 * pad) + 2 * c.K + 2 * pow2_at_least(c.n_snr) +
         2 * (c.n_fft - c.hop);
}

__global__ void __launch_bounds__(kThreads) streaming_suppressor(SupIO io, SupConsts c) {
  extern __shared__ float sm[];
  const int N = c.n_fft, hop = c.hop, K = c.K, T = c.n_frames, F = N / 2 + 1;
  const int tail = N - hop, pad = c.n_taps / 2, m = pow2_at_least(c.n_snr);
  float* const cosT = sm;
  float* const sinT = cosT + N;
  float* const w = sinT + N;
  float* const frame = w + N;
  float* const inv_ws = frame + N;
  float* const Sre = inv_ws + hop;
  float* const Sim = Sre + F;
  float* const sG = Sim + F;        // [pad zeros | K gains | pad zeros]
  float* const sP = sG + K + 2 * pad;
  float* const sNe = sP + K;
  float* const red = sNe + K;       // [2][m]
  float* const ola = red + 2 * m;   // [2][tail]

  const int b = blockIdx.x, tid = threadIdx.x;
  for (int i = tid; i < N; i += kThreads) {
    w[i] = io.tables[i];
    cosT[i] = io.tables[N + hop + i];
    sinT[i] = io.tables[2 * N + hop + i];
  }
  for (int i = tid; i < hop; i += kThreads) inv_ws[i] = io.tables[N + i];
  for (int i = tid; i < tail; i += kThreads) ola[i] = io.ola[(long long)b * tail + i];
  for (int i = tid; i < pad; i += kThreads) sG[i] = sG[pad + K + i] = 0.f;

  const bool lane = tid < K;
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
  const float* const xrow = io.xa + (long long)b * io.xa_len;
  const float* const prow = io.P + (long long)b * io.p_clip + (long long)(c.row0 + tid) * io.p_row;
  const float one_minus_up = __fsub_rn(1.f, c.ema_up);
  const float one_minus_down = __fsub_rn(1.f, c.ema_down);
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const int buf = t & 1;
    for (int n = tid; n < N; n += kThreads) frame[n] = __fmul_rn(xrow[(long long)t * hop + n], w[n]);
    const bool rain = io.frame_class[(long long)b * T + t] != 0;
    const float nc = io.noise_conf[(long long)b * T + t];
    const bool seed = frame0 + t == 0;
    const bool allow = (wcount < c.warmup_need) || !rain;

    // ---- the PSD step and N_eff (band bin tid) ----
    float pt = 0.f, n_eff = 0.f;
    if (lane) {
      pt = prow[t];
      const float err = __fsub_rn(pt, tracker);
      const float scale_new = __fadd_rn(__fmul_rn(c.scale_alpha, scale),
                                        __fmul_rn(c.one_minus_scale_alpha, fabsf(err)));
      const float step = __fmul_rn(c.eta, nan_max(scale_new, c.step_floor));
      float up = c.q, down = c.neg_one_minus_q;
      if (c.adaptive_q) {
        float q_eff = __fsub_rn(c.q, __fmul_rn(c.q_minus_aq_min, rain_ema));
        q_eff = clamp(q_eff, c.aq_min, c.q);
        up = q_eff;
        down = -__fsub_rn(1.f, q_eff);
      }
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
      n_eff = nan_min(n_used, __fmul_rn(c.maxr, pt));
      tracker = tracker_new;
      scale = scale_out;
      prev_n = n;
      sP[tid] = pt;
      sNe[tid] = n_eff;
    }
    wcount += allow ? 1 : 0;
    rain_ema = __fadd_rn(__fmul_rn(c.aq_alpha, rain_ema),
                         __fmul_rn(c.one_minus_aq_alpha, rain ? 1.f : 0.f));
    first = false;
    __syncthreads();

    // ---- the forward real DFT of the windowed frame ----
    for (int j = tid; j < F; j += kThreads) {
      float re = 0.f, im = 0.f;
      for (int n = 0; n < N; ++n) {
        const int idx = (j * n) & (N - 1);
        re = fmaf(frame[n], cosT[idx], re);
        im = fmaf(frame[n], sinT[idx], im);
      }
      Sre[j] = re;
      Sim[j] = -im;
    }

    // ---- the SNR gate: the two sums as a tree, element i + h onto i ----
    const bool gated = c.n_snr > 0;
    float gate = 0.f;
    if (gated) {
      for (int i = tid; i < m; i += kThreads) {
        const bool in = i < c.n_snr;
        red[i] = in ? sP[io.snr_cols[i]] : 0.f;
        red[m + i] = in ? sNe[io.snr_cols[i]] : 0.f;
      }
      __syncthreads();
      for (int h = m / 2; h >= 1; h /= 2) {
        for (int i = tid; i < h; i += kThreads) {
          red[i] = __fadd_rn(red[i], red[i + h]);
          red[m + i] = __fadd_rn(red[m + i], red[m + i + h]);
        }
        __syncthreads();
      }
      const float snr = __fdiv_rn(red[0], __fadd_rn(red[m], c.eps));
      gate = __fdiv_rn(snr, __fadd_rn(snr, c.snr1));
      // gate ** p as exp(p log gate) in double, rounded once to float, as
      // the plain loop computes it (models/streaming.py::_gate_power)
      if (c.snr_pow)
        gate = (float)exp(__dmul_rn(log((double)clamp(gate, 0.f, 1.f)), (double)c.snr_pwr));
      gate = clamp(gate, 0.f, 1.f);
    }

    // ---- gain_freq_stage: the raw gain ----
    const float ncc = clamp(nc, 0.f, 1.f);
    float oversub = c.oversub_base;
    if (c.adaptive_gain) {
      const float eff = clamp(__fdiv_rn(__fsub_rn(ncc, c.th), c.denom), 0.f, 1.f);
      oversub = __fadd_rn(__fmul_rn(eff, c.oversub_span), c.oversub_base);
      if (gated) oversub = __fmul_rn(oversub, __fsub_rn(1.f, clamp(gate, 0.f, 1.f)));
    }
    if (lane) {
      float g;
      if (c.wiener) {
        g = __fdiv_rn(nan_max(__fsub_rn(pt, __fmul_rn(oversub, n_eff)), 0.f), __fadd_rn(pt, c.eps));
      } else {
        const float ratio = clamp(__fdiv_rn(n_eff, __fadd_rn(pt, c.eps)), 0.f, 1.f);
        g = __fsub_rn(1.f, __fmul_rn(oversub, __fsqrt_rn(ratio)));
      }
      sG[pad + tid] = clamp(g, c.gain_floor, c.gain_ceil);
    }
    __syncthreads();

    // ---- smoothing over frequency, the EMA over time, S_hat ----
    if (lane) {
      float gf = sG[pad + tid];
      if (c.n_taps > 0) {
        float conv = 0.f;
        for (int i = 0; i < c.n_taps; ++i) conv = __fadd_rn(conv, __fmul_rn(c.taps[i], sG[tid + i]));
        if (!c.adaptive_gain || ncc >= c.th) gf = conv;
      }
      float gt;
      if (c.adaptive_gain) {
        const bool below = nc < c.th;
        const float alpha = below ? 0.f : __fmul_rn(c.alpha_base, __fdiv_rn(__fsub_rn(nc, c.th), c.denom));
        gt = __fadd_rn(__fmul_rn(alpha, g_prev), __fmul_rn(__fsub_rn(1.f, alpha), gf));
        if (below) gt = nan_max(gt, gf);
      } else {
        gt = __fadd_rn(__fmul_rn(c.alpha_base, g_prev), __fmul_rn(c.one_minus_alpha_base, gf));
      }
      if (seed) gt = gf;
      g_prev = gt;
      const float gout = clamp(gt, c.gain_floor, c.gain_ceil);
      if (io.g_out) io.g_out[lk * T + t] = gout;
      const int row = c.row0 + tid;
      Sre[row] = __fmul_rn(Sre[row], gout);
      Sim[row] = __fmul_rn(Sim[row], gout);
    }
    __syncthreads();

    // ---- the inverse real DFT, the window, the overlap-add ----
    const float scale_n = 1.f / (float)N;
    for (int n = tid; n < N; n += kThreads) {
      float acc = 0.f;
      for (int k = 1; k < N / 2; ++k) {
        const int idx = (k * n) & (N - 1);
        acc = fmaf(Sre[k], cosT[idx], acc);
        acc = fmaf(-Sim[k], sinT[idx], acc);
      }
      const float v = Sre[0] + ((n & 1) ? -Sre[N / 2] : Sre[N / 2]) + 2.f * acc;
      const float recon = (v * scale_n) * w[n];
      if (n < hop) {
        io.y[(long long)b * T * hop + (long long)t * hop + n] =
            __fmul_rn(__fadd_rn(recon, ola[buf * tail + n]), inv_ws[n]);
      } else {
        ola[(buf ^ 1) * tail + n - hop] = recon;
      }
    }
  }
  __syncthreads();

  if (lane) {
    io.o_tracker[lk] = tracker;
    io.o_scale[lk] = scale;
    io.o_prev_n[lk] = prev_n;
    io.o_g_prev[lk] = g_prev;
  }
  if (tid == 0) {
    io.o_wcount[b] = wcount;
    io.o_rain_ema[b] = rain_ema;
  }
  for (int i = tid; i < tail; i += kThreads) io.o_ola[(long long)b * tail + i] = ola[(T & 1) * tail + i];
}

}  // namespace

// One chunk of B streams; see SupIO and SupConsts.  Refuses what the kernel
// does not take: n_fft not a power of two up to 1024 or not 2 hop, more band
// bins than threads, band bins outside the spectrum, more than 9 taps.
// (The structures are passed as untyped pointers: a function whose
// parameter types lie in an unnamed namespace gets internal linkage.)
extern "C" int apt_streaming_suppressor(const void* io_ptr, const void* c_ptr, int smem_bytes,
                                        void* stream) {
  const SupIO* io = static_cast<const SupIO*>(io_ptr);
  const SupConsts* c = static_cast<const SupConsts*>(c_ptr);
  const int N = c->n_fft;
  if (N < 4 || N > kMaxFft || (N & (N - 1)) || c->hop * 2 != N || c->K < 1 || c->K > kThreads ||
      c->row0 < 0 || c->row0 + c->K > N / 2 + 1 || c->n_taps < 0 || c->n_taps > kMaxTaps ||
      c->n_snr < 0 || c->n_snr > c->K || c->n_frames < 1 || c->n_streams < 1)
    return (int)cudaErrorInvalidValue;
  if ((size_t)smem_bytes != sizeof(float) * (size_t)smem_floats(*c) || smem_bytes > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  streaming_suppressor<<<c->n_streams, kThreads, smem_bytes, (cudaStream_t)stream>>>(*io, *c);
  return (int)cudaGetLastError();
}
