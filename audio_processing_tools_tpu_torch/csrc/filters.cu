// K7: the cascaded-biquad filter with initial and final state, scipy's
// `sosfilt(sos, x, zi=zi)` -> (y, zf), hand-written for Hopper (sm_90a).
//
// It replaces `_sosfilt_section_pscan`
// (audio_processing_tools_tpu/ops/filters.py:290-411), the per-section
// blocked two-level parallel scan that `sosfilt(..., zi=...)` runs
// (:669-712).  Its one caller on the product path is the streaming
// detector's causal TD prefilter (models/streaming.py:288-291), which
// carries `zi` from one chunk of a live stream to the next.
//
// What bounds it on this card.  At the live batch (64 streams x 22,272
// samples, a 2 s chunk) the bytes are 5.7 MB in and 5.7 MB out, 3.4 us at
// 3.35 TB/s.  But each sample of each section waits for the previous one:
// y[n] -> a1 * y[n] -> b1 x[n] - a1 y[n] -> + z1 -> y[n + 1] is four dependent
// float operations, ~16 cycles, so one stream takes ~22,272 x 16 cycles, about
// 0.18 ms at 1.98 GHz, whatever the card's width.  The chain sets the time.
//
// Design.  One thread per stream walks the samples in order through all S
// sections, the state in registers (the section count is a template
// parameter, so the state arrays stay in registers).  That order is the
// definition of the filter, so the result does not depend on where a
// stream is cut into chunks: chunk invariance holds bit for bit, which the
// JAX blocked scan, anchored at the chunk start, does not give.  Each
// stream has a block of its own: threads of one warp on different streams
// read and write a different row per instruction, one L1 wavefront per row,
// and with 64 streams in one block that throughput, not the chain, set the
// time (1.91 ms at 64 x 22,272 on the H100, ~160 cycles a sample).  The
// samples of the next batch of 32 are loaded while this batch is filtered,
// so a load's latency stays out of the chain.  The blocked form (a prefix
// over blocks, as the JAX package's) would spread a stream over many
// threads; it is later work.
//
// Arithmetic: Direct Form II transposed, as scipy and the plain PyTorch
// loop (ops/filters.py::_sosfilt_zi_plain) write it,
//     y  = b0 x + z0
//     z0 = (b1 x - a1 y) + z1
//     z1 = b2 x - a2 y
// every product and sum rounded on its own (__fmul_rn / __fadd_rn /
// __fsub_rn, never contracted into an FMA), with the coefficients rounded to
// float as the JAX package rounds them; so the kernel gives the plain
// loop's bits.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1;       // streams per block: one, see above
constexpr int kMaxSections = 8;   // second-order sections the launcher takes
constexpr int kBatch = 32;        // samples loaded ahead of the chain

template <int S>
__global__ void __launch_bounds__(kThreads)
sosfilt_zi(const float* __restrict__ x, const float* __restrict__ coef,
           const float* __restrict__ zi, float* __restrict__ y, float* __restrict__ zf,
           int R, long long n) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= R) return;
  float b0[S], b1[S], b2[S], a1[S], a2[S], z0[S], z1[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    b0[s] = coef[5 * s];
    b1[s] = coef[5 * s + 1];
    b2[s] = coef[5 * s + 2];
    a1[s] = coef[5 * s + 3];
    a2[s] = coef[5 * s + 4];
    z0[s] = zi[((long long)r * S + s) * 2];
    z1[s] = zi[((long long)r * S + s) * 2 + 1];
  }
  const float* xr = x + (long long)r * n;
  float* yr = y + (long long)r * n;

  float xs[kBatch];
#pragma unroll
  for (int u = 0; u < kBatch; ++u) xs[u] = u < n ? xr[u] : 0.f;
  for (long long t0 = 0; t0 < n; t0 += kBatch) {
    float xn[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const long long t = t0 + kBatch + u;
      xn[u] = t < n ? xr[t] : 0.f;
    }
    // one sample through the sections
    auto step = [&](float v) {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float out = __fadd_rn(__fmul_rn(b0[s], v), z0[s]);
        z0[s] = __fadd_rn(__fsub_rn(__fmul_rn(b1[s], v), __fmul_rn(a1[s], out)), z1[s]);
        z1[s] = __fsub_rn(__fmul_rn(b2[s], v), __fmul_rn(a2[s], out));
        v = out;
      }
      return v;
    };
    if (t0 + kBatch <= n) {
      // a whole batch without a test per sample, so that the compiler can
      // overlap one sample's later sections with the next sample's first
#pragma unroll
      for (int u = 0; u < kBatch; ++u) yr[t0 + u] = step(xs[u]);
    } else {
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (t0 + u < n) yr[t0 + u] = step(xs[u]);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) xs[u] = xn[u];
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
    zf[((long long)r * S + s) * 2] = z0[s];
    zf[((long long)r * S + s) * 2 + 1] = z1[s];
  }
}

template <int S>
cudaError_t launch(const float* x, const float* coef, const float* zi, float* y, float* zf,
                   int R, long long n, cudaStream_t stream) {
  sosfilt_zi<S><<<(R + kThreads - 1) / kThreads, kThreads, 0, stream>>>(x, coef, zi, y, zf, R, n);
  return cudaGetLastError();
}

}  // namespace

// x, y: (R, n) contiguous; coef: (S, 5) = b0, b1, b2, a1, a2 per section
// (a0 = 1); zi, zf: (R, S, 2) contiguous.  1 <= S <= 8.
extern "C" int apt_sosfilt_zi(const float* x, const float* coef, const float* zi, float* y,
                              float* zf, int R, long long n, int S, void* stream) {
  if (R <= 0 || n < 0 || S < 1 || S > kMaxSections) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (S) {
    case 1: return (int)launch<1>(x, coef, zi, y, zf, R, n, st);
    case 2: return (int)launch<2>(x, coef, zi, y, zf, R, n, st);
    case 3: return (int)launch<3>(x, coef, zi, y, zf, R, n, st);
    case 4: return (int)launch<4>(x, coef, zi, y, zf, R, n, st);
    case 5: return (int)launch<5>(x, coef, zi, y, zf, R, n, st);
    case 6: return (int)launch<6>(x, coef, zi, y, zf, R, n, st);
    case 7: return (int)launch<7>(x, coef, zi, y, zf, R, n, st);
    default: return (int)launch<8>(x, coef, zi, y, zf, R, n, st);
  }
}
