// K2 and K3: the two per-frame tracker recurrences of the detector path,
// hand-written for Hopper (sm_90a).
//
// K2 replaces the `lax.scan` of `noise_psd_track`
// (audio_processing_tools_tpu/ops/trackers.py:121-201, step at :160-196);
// K3 replaces the `lax.scan` of `causal_low_quantile_baseline` (:30-82,
// step at :65-73, epilogue at :77-81).  Neither was a Pallas kernel: XLA
// compiled each scan into one loop on the TPU.  Eager PyTorch has no compiled
// scan, so written as tensor code each of the T = 873 steps would launch a
// dozen or more tiny kernels.
//
// What bounds them on this card: the sequential chain of T dependent steps,
// ~15 floating-point operations each, per lane.  The data is small (K2 reads
// 128 * 71 * 873 floats = 32 MB and writes as much; K3 reads and writes
// 768 * 873 floats = 2.7 MB), so the kernels are bound by the latency of the
// chain, not by bandwidth or FLOPs.
//
// Design: one thread per independent lane, walking T with the whole carry
// in registers: K2 one thread per (clip, band bin) lane, 128 * 71 = 9,088
// lanes, with the 5-value carry of trackers.py:148-155; K3 one thread per
// row of the stacked (clips * (1 + modes), T) flux, 768 rows, with the NaN /
// floor epilogue applied at the store.  Loads along T are uncoalesced across
// a warp; at these sizes that does not matter yet.
//
// Arithmetic follows the plain PyTorch loops step for step: every product
// and sum is rounded on its own (__fmul_rn / __fadd_rn / __fsub_rn are never
// contracted into an FMA), constants arrive already rounded to float by the
// host exactly as the JAX program rounds them, and max/min propagate NaN as
// jnp.maximum/minimum do.  So the kernels give the plain loops' bits, and
// no value moves across a decision threshold.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// jnp.maximum / jnp.minimum: NaN in either operand gives NaN
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || a < b) ? a : b;
}

struct PsdConsts {
  float eta, scale_alpha, one_minus_scale_alpha, step_floor;
  int warmup_need;
  float q, neg_one_minus_q;
  int adaptive;
  float aq_min, q_minus_aq_min, ema_up, ema_down, maxr;
  float aq_alpha, one_minus_aq_alpha;
};

__global__ void noise_psd_track_kernel(const float* __restrict__ P,
                                       const uint8_t* __restrict__ rain,
                                       float* __restrict__ out, int B, int K,
                                       int T, PsdConsts c) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B * K) return;
  const int b = lane / K;
  const float* p = P + (size_t)lane * T;
  const uint8_t* r = rain + (size_t)b * T;
  float* o = out + (size_t)lane * T;

  const float first = p[0];
  float tracker = nan_max(first, 0.f);
  float scale = nan_max(fabsf(first), c.step_floor);
  float prev_n = 0.f;
  int wcount = 0;
  float rain_ema = 0.f;
  for (int t = 0; t < T; ++t) {
    const float pt = p[t];
    const bool raint = r[t] != 0;
    const bool allow = (wcount < c.warmup_need) || !raint;

    const float err = __fsub_rn(pt, tracker);
    const float scale_new = __fadd_rn(__fmul_rn(c.scale_alpha, scale),
                                      __fmul_rn(c.one_minus_scale_alpha, fabsf(err)));
    const float step = __fmul_rn(c.eta, nan_max(scale_new, c.step_floor));
    float up, down;
    if (c.adaptive) {
      float q_eff = __fsub_rn(c.q, __fmul_rn(c.q_minus_aq_min, rain_ema));
      q_eff = nan_min(nan_max(q_eff, c.aq_min), c.q);
      up = __fmul_rn(q_eff, step);
      down = __fmul_rn(-__fsub_rn(1.f, q_eff), step);
    } else {
      up = __fmul_rn(c.q, step);
      down = __fmul_rn(c.neg_one_minus_q, step);
    }
    const float delta = (pt >= tracker) ? up : down;
    const float candidate = nan_max(__fadd_rn(tracker, delta), 0.f);
    // the first frame keeps the initial tracker and scale
    const float tracker_new = (t == 0 || !allow) ? tracker : candidate;
    const float scale_out = (t == 0) ? scale : scale_new;

    const float lam = (tracker_new > prev_n) ? c.ema_up : c.ema_down;
    const float n_ema = __fadd_rn(__fmul_rn(lam, prev_n),
                                  __fmul_rn(__fsub_rn(1.f, lam), tracker_new));
    float n = (t == 0) ? tracker_new : n_ema;
    n = nan_min(n, __fmul_rn(c.maxr, pt));
    n = nan_max(n, 0.f);
    o[t] = n;

    wcount += allow ? 1 : 0;
    rain_ema = __fadd_rn(__fmul_rn(c.aq_alpha, rain_ema),
                         __fmul_rn(c.one_minus_aq_alpha, raint ? 1.f : 0.f));
    tracker = tracker_new;
    scale = scale_out;
    prev_n = n;
  }
}

struct BaselineConsts {
  float q, neg_one_minus_q, eta, scale_alpha, one_minus_scale_alpha, floor;
};

__global__ void causal_low_quantile_baseline_kernel(const float* __restrict__ x,
                                                    float* __restrict__ out,
                                                    int R, int T,
                                                    BaselineConsts c) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= R) return;
  const float* xr = x + (size_t)row * T;
  float* o = out + (size_t)row * T;

  const float x0 = xr[0];
  float baseline = nan_max(x0, c.floor);
  float scale = nan_max(fabsf(x0), c.floor);
  for (int t = 0; t < T; ++t) {
    // emit before ingesting x[t]; nan_to_num(nan/inf -> floor), then floor
    const float e = isfinite(baseline) ? baseline : c.floor;
    o[t] = nan_max(e, c.floor);

    const float xt = xr[t];
    const float err = __fsub_rn(xt, baseline);
    scale = __fadd_rn(__fmul_rn(c.scale_alpha, scale),
                      __fmul_rn(c.one_minus_scale_alpha, fabsf(err)));
    const float step = __fmul_rn(c.eta, nan_max(scale, c.floor));
    const float delta = (xt >= baseline) ? __fmul_rn(c.q, step)
                                         : __fmul_rn(c.neg_one_minus_q, step);
    baseline = nan_max(__fadd_rn(baseline, delta), c.floor);
  }
}

constexpr int kBlock = 128;

}  // namespace

extern "C" int apt_noise_psd_track(
    const float* P, const uint8_t* rain, float* out, int B, int K, int T,
    float eta, float scale_alpha, float one_minus_scale_alpha,
    float step_floor, int warmup_need, float q, float neg_one_minus_q,
    int adaptive, float aq_min, float q_minus_aq_min, float ema_up,
    float ema_down, float maxr, float aq_alpha, float one_minus_aq_alpha,
    void* stream) {
  if (B <= 0 || K <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  const PsdConsts c{eta, scale_alpha, one_minus_scale_alpha, step_floor,
                    warmup_need, q, neg_one_minus_q, adaptive, aq_min,
                    q_minus_aq_min, ema_up, ema_down, maxr, aq_alpha,
                    one_minus_aq_alpha};
  const int lanes = B * K;
  noise_psd_track_kernel<<<(lanes + kBlock - 1) / kBlock, kBlock, 0,
                           (cudaStream_t)stream>>>(P, rain, out, B, K, T, c);
  return (int)cudaGetLastError();
}

extern "C" int apt_causal_low_quantile_baseline(
    const float* x, float* out, int R, int T, float q, float neg_one_minus_q,
    float eta, float scale_alpha, float one_minus_scale_alpha, float floor,
    void* stream) {
  if (R <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  const BaselineConsts c{q, neg_one_minus_q, eta, scale_alpha,
                         one_minus_scale_alpha, floor};
  causal_low_quantile_baseline_kernel<<<(R + kBlock - 1) / kBlock, kBlock, 0,
                                        (cudaStream_t)stream>>>(x, out, R, T,
                                                                c);
  return (int)cudaGetLastError();
}
