// The direct real DFT of K1's DFT route (spectrogram_power.cu) and K8's DFT
// frame pass (streaming.cu), which only comparisons force: any n whose tile
// fits, an O(n^2) check on the card that shares no code with the FFT
// routes.  It is what the TPU kernel computes, a window-and-DFT matrix
// product, as fp32 FMA chains.  The twiddles come from the host table
// table[j] = e^{-2 pi i j / n} (float64 rounded to float32), indexed by
// (k m) mod n, which a thread walks by adding k and subtracting n: no sine
// of a large angle anywhere.
//
// A tile of frames lies in shared memory frame-fastest, xs[m * ld + f], so
// the FPT frames a thread sums read as one broadcast (FPT a multiple of 4:
// 16-byte loads; ld and f0 multiples of 4 then).  Each frame's sums run in
// the same order wherever the frame lies in a tile, so a frame's result does
// not depend on the tile, the chunk or the batch it came in.
#pragma once

#include <cuda_runtime.h>

namespace {

// FPT frames' values at row m of a frame-fastest tile
template <int FPT>
__device__ __forceinline__ void tile_row(const float* row, float (&v)[FPT]) {
  if constexpr (FPT % 4 == 0) {
#pragma unroll
    for (int f = 0; f < FPT; f += 4) {
      const float4 q = *reinterpret_cast<const float4*>(row + f);
      v[f] = q.x;
      v[f + 1] = q.y;
      v[f + 2] = q.z;
      v[f + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int f = 0; f < FPT; ++f) v[f] = row[f];
  }
}

// X[k] = sum_m xs[m][f] e^{-2 pi i k m / n}, m = 0 .. n - 1 in order, for
// frames f0 .. f0 + FPT - 1 of the tile.
template <int FPT>
__device__ __forceinline__ void dft_forward(const float* xs, int ld, int f0, const float2* tw,
                                            int n, int k, float (&re)[FPT], float (&im)[FPT]) {
#pragma unroll
  for (int f = 0; f < FPT; ++f) re[f] = im[f] = 0.f;
  int idx = 0;
  for (int m = 0; m < n; ++m) {
    const float2 w = tw[idx];
    float v[FPT];
    tile_row<FPT>(xs + (long long)m * ld + f0, v);
#pragma unroll
    for (int f = 0; f < FPT; ++f) {
      re[f] = fmaf(v[f], w.x, re[f]);
      im[f] = fmaf(v[f], w.y, im[f]);
    }
    idx += k;
    if (idx >= n) idx -= n;
  }
}

// n x[m] of the inverse real DFT of an even n from bins 0 .. n / 2 held as
// X[k * ld + f] (the imaginary parts of bins 0 and n / 2 are not read, as
// an inverse real FFT ignores them):
//   n x[m] = X_0 + (-1)^m X_{n/2} + 2 sum_{k=1}^{n/2-1} Re(X_k e^{2 pi i k m / n}),
// the sum over k in order, for frames f0 .. f0 + FPT - 1.
template <int FPT>
__device__ __forceinline__ void dft_inverse_real(const float2* X, int ld, int f0, const float2* tw,
                                                 int n, int m, float (&y)[FPT]) {
  const int M = n / 2;
  float acc[FPT];
#pragma unroll
  for (int f = 0; f < FPT; ++f) acc[f] = 0.f;
  int idx = m;
  for (int k = 1; k < M; ++k) {
    const float2 w = tw[idx];  // e^{-2 pi i k m / n}: Re(X e^{+i..}) = X.x w.x + X.y w.y
    const float2* xk = X + (long long)k * ld + f0;
#pragma unroll
    for (int f = 0; f < FPT; ++f) {
      const float2 xv = xk[f];
      acc[f] = fmaf(xv.y, w.y, fmaf(xv.x, w.x, acc[f]));
    }
    idx += m;
    if (idx >= n) idx -= n;
  }
  const float2* x0 = X + f0;
  const float2* xm = X + (long long)M * ld + f0;
#pragma unroll
  for (int f = 0; f < FPT; ++f) {
    const float edge = (m & 1) ? x0[f].x - xm[f].x : x0[f].x + xm[f].x;
    y[f] = edge + 2.f * acc[f];
  }
}

}  // namespace
