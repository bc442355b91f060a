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
// What bounds it on this card: the chain of T dependent steps per lane, a
// handful of floating-point operations each.  The data is small (G_freq is
// 128 * 71 * 873 floats = 32 MB read, as much written), so the kernel is bound
// by the latency of the chain, not by bandwidth or FLOPs.
//
// Design: one thread per (clip, band bin) lane, 128 * 71 = 9,088 lanes,
// walking T with the carry G_{t-1} in a register, as K2 does.  The lane's
// clip reads its noise_conf row, which its neighbours in the warp share.
// Loads along T are uncoalesced across a warp; at these sizes that does not
// matter yet.
//
// Arithmetic follows the plain PyTorch loop step for step: every product,
// sum and quotient is rounded on its own (__fmul_rn / __fadd_rn / __fdiv_rn
// are never contracted into an FMA), the constants arrive rounded to float
// by the host as the JAX program rounds them (0.7, denom and alpha_base to
// float32, `1 - alpha_t` in float32, but `1 - alpha_base` in double and then
// rounded), and max/min propagate NaN as jnp.maximum/minimum do.  So the
// kernel gives the plain loop's bits.

#include <cuda_runtime.h>

namespace {

// jnp.maximum / jnp.minimum: NaN in either operand gives NaN
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || a < b) ? a : b;
}

struct GainConsts {
  int adaptive;
  float th, denom, alpha_base, one_minus_alpha_base, floor, ceil;
};

__device__ __forceinline__ float clip(float g, const GainConsts& c) {
  return nan_min(nan_max(g, c.floor), c.ceil);
}

__global__ void gain_time_smooth_kernel(const float* __restrict__ g_freq,
                                        const float* __restrict__ nc,
                                        float* __restrict__ out, int B, int K,
                                        int T, GainConsts c) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B * K) return;
  const int b = lane / K;
  const float* gf = g_freq + (size_t)lane * T;
  const float* n = nc + (size_t)b * T;
  float* o = out + (size_t)lane * T;

  float g = gf[0];
  o[0] = clip(g, c);
  for (int t = 1; t < T; ++t) {
    const float gft = gf[t];
    float gt;
    if (c.adaptive) {
      const float nct = n[t];
      const bool below = nct < c.th;
      const float alpha =
          below ? 0.f : __fmul_rn(c.alpha_base, __fdiv_rn(__fsub_rn(nct, c.th), c.denom));
      gt = __fadd_rn(__fmul_rn(alpha, g), __fmul_rn(__fsub_rn(1.f, alpha), gft));
      if (below) gt = nan_max(gt, gft);
    } else {
      gt = __fadd_rn(__fmul_rn(c.alpha_base, g), __fmul_rn(c.one_minus_alpha_base, gft));
    }
    g = gt;
    o[t] = clip(g, c);
  }
}

constexpr int kBlock = 128;

}  // namespace

extern "C" int apt_gain_time_smooth(const float* g_freq, const float* nc,
                                    float* out, int B, int K, int T,
                                    int adaptive, float th, float denom,
                                    float alpha_base,
                                    float one_minus_alpha_base, float floor,
                                    float ceil, void* stream) {
  if (B <= 0 || K <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  const GainConsts c{adaptive, th, denom, alpha_base, one_minus_alpha_base,
                     floor, ceil};
  const int lanes = B * K;
  gain_time_smooth_kernel<<<(lanes + kBlock - 1) / kBlock, kBlock, 0,
                            (cudaStream_t)stream>>>(g_freq, nc, out, B, K, T,
                                                    c);
  return (int)cudaGetLastError();
}
