// The half-length complex Stockham FFT of K1 (spectrogram_power.cu) and K8's
// frame pass (streaming.cu): a group of G = M / 8 threads transforms M
// points, 8 points per thread in registers, exchanging through a per-frame
// buffer in shared memory that is XOR-swizzled so the strided Stockham
// writes hit distinct banks.  Twiddles are host tables built in float64 and
// rounded to float32: table[k] = e^{-2 pi i k / (2 M)}.
//
// A pass: `first_radix8` (radix 8 on the thread's points m = t + r G, r <
// 8, natural order in), then `stockham_pass<M, R2, 8>` with R2 = min(M/8,
// 8) and, for M > 64, `stockham_pass<M, M/64, 64>`; the result is in the
// buffer in natural order (`buf[swz(k)]`).
#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int swz(int i) { return i ^ ((i >> 3) & 15); }

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ void bfly(float2& a, float2& b) {
  const float2 t = a;
  a = make_float2(t.x + b.x, t.y + b.y);
  b = make_float2(t.x - b.x, t.y - b.y);
}
__device__ __forceinline__ float2 mul_neg_i(float2 a) { return make_float2(a.y, -a.x); }

// In-register DFTs, natural order in and out.
template <int R>
__device__ __forceinline__ void dft(float2* a);

template <>
__device__ __forceinline__ void dft<2>(float2* a) {
  bfly(a[0], a[1]);
}

template <>
__device__ __forceinline__ void dft<4>(float2* a) {
  bfly(a[0], a[2]);
  bfly(a[1], a[3]);
  a[3] = mul_neg_i(a[3]);
  bfly(a[0], a[1]);
  bfly(a[2], a[3]);
  const float2 t = a[1];  // a = X0, X2, X1, X3
  a[1] = a[2];
  a[2] = t;
}

template <>
__device__ __forceinline__ void dft<8>(float2* a) {
  constexpr float h = 0.70710678118654752440f;
  bfly(a[0], a[4]);
  bfly(a[1], a[5]);
  bfly(a[2], a[6]);
  bfly(a[3], a[7]);
  a[5] = make_float2(h * (a[5].x + a[5].y), h * (a[5].y - a[5].x));   // * e^{-i pi/4}
  a[6] = mul_neg_i(a[6]);                                             // * e^{-i pi/2}
  a[7] = make_float2(h * (a[7].y - a[7].x), -h * (a[7].x + a[7].y));  // * e^{-3i pi/4}
  dft<4>(a);      // X0, X2, X4, X6
  dft<4>(a + 4);  // X1, X3, X5, X7
  const float2 u1 = a[1], u2 = a[2], u3 = a[3];
  a[1] = a[4];
  a[2] = u1;
  a[4] = u2;
  a[3] = a[5];
  a[5] = a[6];
  a[6] = u3;
}

template <int G>
__device__ __forceinline__ void group_sync() {
  if constexpr (G <= 32) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// Per-thread twiddles of a Stockham pass of radix R after NS points:
// value q*R + r multiplies input r of butterfly j = t + q*G by
// e^{-2 pi i (j % NS) r / (NS R)} = table[2 (j % NS) r M / (NS R)].
template <int M, int R, int NS>
__device__ __forceinline__ void pass_twiddles(const float2* __restrict__ table, int t,
                                              float2 (&tw)[8]) {
  constexpr int G = M / 8;
#pragma unroll
  for (int q = 0; q < 8 / R; ++q) {
    const int j = t + q * G;
#pragma unroll
    for (int r = 0; r < R; ++r) tw[q * R + r] = __ldg(table + 2 * ((j % NS) * r * (M / (NS * R))));
  }
}

// Radix 8 on the thread's points v[r] = z[t + r G] (NS = 1), stored to the
// exchange buffer for the next pass.
template <int M>
__device__ __forceinline__ void first_radix8(float2 (&v)[8], float2* buf, int t) {
  constexpr int G = M / 8;
  dft<8>(v);
#pragma unroll
  for (int r = 0; r < 8; ++r) buf[swz(8 * t + r)] = v[r];
  group_sync<G>();
}

template <int M, int R, int NS>
__device__ __forceinline__ void stockham_pass(float2* buf, int t, const float2 (&tw)[8]) {
  constexpr int G = M / 8;
  constexpr int Q = 8 / R;
  float2 v[8];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
#pragma unroll
    for (int r = 0; r < R; ++r) v[q * R + r] = buf[swz(t + q * G + r * (M / R))];
  }
  group_sync<G>();
#pragma unroll
  for (int q = 0; q < Q; ++q) {
#pragma unroll
    for (int r = 1; r < R; ++r) v[q * R + r] = cmul(v[q * R + r], tw[q * R + r]);
    dft<R>(v + q * R);
    const int j = t + q * G;
    const int dst = (j / NS) * NS * R + j % NS;
#pragma unroll
    for (int r = 0; r < R; ++r) buf[swz(dst + r * NS)] = v[q * R + r];
  }
  group_sync<G>();
}

}  // namespace
