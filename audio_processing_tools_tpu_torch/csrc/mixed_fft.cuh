// The mixed-radix shared-memory FFT of K1 (spectrogram_power.cu) and K8's
// frame passes (streaming.cu): the complex Stockham transform of M points
// for every M = 2^a q whose odd part q has no prime factor above kMaxPrime.
// Its uses: the half-length transform of an even frame (M = n / 2, the
// real-input packing z[m] = x[2m] + i x[2m+1] of the power-of-two route:
// the mixed route, which takes every frame size of the TPU kernel's
// geometry set, n_fft = 128 m, m <= 32, and most sizes users type, 400,
// 480, 500, 1,000); the whole transform of an odd frame (M = n, the odd
// mixed route); the M-point convolutions of the chirp-z and Rader routes;
// the column and row transforms of the four-step FFT (four_step.cuh); and
// the cluster route's columns and rows (cluster_fft.cuh, lines_fft over
// Lines).
//
// Plan (mixed_plan_of, mirrored by ops/spectrogram.py::mixed_radices):
// radix-8 passes while 8 divides the power of two, then one radix-4 or
// radix-2 pass, then the odd primes in ascending order.  Radix 2, 4 and 8
// are stockham_fft.cuh's register DFTs; every odd prime p (3 to kMaxPrime)
// is one register butterfly, dft_odd<p>, in the symmetric form (sums and
// differences of x_j and x_{p-j}, (p-1)^2 / 2 real multiply-adds).
//
// Layout: a tile of ft = 2^lg frames lies frame-fastest in shared memory,
// point m of frame f at buf[m * ld + f], ld = tile_ld(ft).  A pass's work item u
// is (frame u mod ft, butterfly u / ft): the lanes of a warp take the
// same butterfly of consecutive frames (one twiddle, consecutive addresses;
// the odd row stride keeps a column walk over points free of bank
// conflicts too).  A pass reads one buffer and writes the other (Stockham
// is out of place) and the block synchronises between passes.
//
// Twiddles are a host table table[j] = e^{-2 pi i j / tn} for a length tn
// that M divides (float64 rounded to float32: K1's and K8's own table of n
// entries, or the chirp-z route's of M), read as table[(k r tn / (NS R))]:
// no sine on the card.  A frame's arithmetic is the same code in the same
// order wherever the frame lies in a tile, so its result does not depend on
// the tile, the chunk or the batch it came in (K8's chunk invariance).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "stockham_fft.cuh"

namespace {

constexpr int kMaxPrime = 31;   // the largest odd prime a pass takes
constexpr int kMaxPasses = 16;  // passes of a plan (a chirp-z size near 131,072 needs 12)

struct MixedPlan {
  int n_pass;
  int radix[kMaxPasses];
};

// The passes of an M-point transform; n_pass = 0 where M < 2 or an odd
// prime factor passes kMaxPrime.
__host__ __device__ inline MixedPlan mixed_plan_of(int M) {
  MixedPlan p;
  p.n_pass = 0;
  if (M < 2) return p;
  int q = M;
  while (q % 8 == 0) {
    p.radix[p.n_pass++] = 8;
    q /= 8;
  }
  if (q % 4 == 0) {
    p.radix[p.n_pass++] = 4;
    q /= 4;
  } else if (q % 2 == 0) {
    p.radix[p.n_pass++] = 2;
    q /= 2;
  }
  for (int f = 3; f <= kMaxPrime && q > 1; f += 2) {
    while (q % f == 0) {
      if (p.n_pass == kMaxPasses) {
        p.n_pass = 0;
        return p;
      }
      p.radix[p.n_pass++] = f;
      q /= f;
    }
  }
  if (q > 1) p.n_pass = 0;
  return p;
}

// The instantiation of mixed_fft a plan needs, by its largest radix: 7
// (radices 2 to 8), 13 (the primes 11 and 13) or 31 (17 to 31).  A wider
// one holds the larger butterflies' registers, which would cut the
// occupancy of the narrower plans.
__host__ __device__ inline int plan_width(const MixedPlan& p) {
  int w = 7;
  for (int i = 0; i < p.n_pass; ++i) {
    if (p.radix[i] > 13) return 31;
    if (p.radix[i] > 8) w = 13;
  }
  return w;
}

// f(std::integral_constant<int, W>{}) for the plan's width W: a launcher
// picks its kernel's instantiation.
template <typename Fn>
auto by_width(const MixedPlan& p, Fn f) {
  switch (plan_width(p)) {
    case 7: return f(std::integral_constant<int, 7>{});
    case 13: return f(std::integral_constant<int, 13>{});
    default: return f(std::integral_constant<int, 31>{});
  }
}

// The p-point DFT of a[0 .. P-1] in place, natural order, P odd:
//   X_0 = a_0 + sum_j s_j,  X_k = A_k - i B_k,  X_{P-k} = A_k + i B_k,
//   A_k = a_0 + sum_j s_j cos(2 pi j k / P),  B_k = sum_j d_j sin(2 pi j k / P),
// s_j = a_j + a_{P-j}, d_j = a_j - a_{P-j}, j = 1 .. (P-1)/2.  cs[m] =
// e^{-2 pi i m / P} for m = 1 .. (P-1)/2, from the twiddle table.
template <int P>
__device__ __forceinline__ void dft_odd(float2 (&a)[P], const float2 (&cs)[P / 2 + 1]) {
  constexpr int H = P / 2;
  float2 s[H + 1], d[H + 1];
#pragma unroll
  for (int j = 1; j <= H; ++j) {
    s[j] = make_float2(a[j].x + a[P - j].x, a[j].y + a[P - j].y);
    d[j] = make_float2(a[j].x - a[P - j].x, a[j].y - a[P - j].y);
  }
  const float2 a0 = a[0];
  float2 x0 = a0;
#pragma unroll
  for (int j = 1; j <= H; ++j) x0 = make_float2(x0.x + s[j].x, x0.y + s[j].y);
  a[0] = x0;
#pragma unroll
  for (int k = 1; k <= H; ++k) {
    float2 A = a0, B = make_float2(0.f, 0.f);
#pragma unroll
    for (int j = 1; j <= H; ++j) {
      const int m = (j * k) % P;
      const float c = m <= H ? cs[m].x : cs[P - m].x;
      const float sn = m <= H ? -cs[m].y : cs[P - m].y;  // sin(2 pi m / P)
      A = make_float2(A.x + s[j].x * c, A.y + s[j].y * c);
      B = make_float2(B.x + d[j].x * sn, B.y + d[j].y * sn);
    }
    a[k] = make_float2(A.x + B.y, A.y - B.x);
    a[P - k] = make_float2(A.x - B.y, A.y + B.x);
  }
}

template <int R>
__device__ __forceinline__ void butterfly(float2 (&v)[R], const float2 (&cs)[R / 2 + 1]) {
  if constexpr (R % 2 == 1) {
    dft_odd<R>(v, cs);
  } else {
    dft<R>(v);
  }
}

// The lines a pass transforms, point m of line f at buf[at(m, f)]: a tile
// of 2^lg frames (Tile, m * ld + f) or any count of lines at two strides
// (Lines, m * ps + f * fs: the cluster route's columns {N1, nc, ldc, 1} and
// rows {N2, nr, 1, ldr}, cluster_fft.cuh, whose counts need not be powers of
// two).
struct Tile {
  int n, lg, ld;
  __device__ __forceinline__ int at(int m, int f) const { return m * ld + f; }
};
struct Lines {
  int n, nf, ps, fs;
  __device__ __forceinline__ int at(int m, int f) const { return m * ps + f * fs; }
};

// A twiddle table in shared memory (the cluster route's); a plain pointer's
// table lies in device memory and is read through the read-only cache.
struct SharedTable {
  const float2* p;
};
__device__ __forceinline__ float2 table_at(const float2* __restrict__ t, int i) {
  return __ldg(t + i);
}
__device__ __forceinline__ float2 table_at(SharedTable t, int i) { return t.p[i]; }

// What a pass does with its output k of line f: store it in the other
// buffer (this type is that store, written out in mixed_pass).  A route may
// hand the last pass another (out(dst, k, f, layout, v)), which takes the
// transform's outputs straight from its registers.
struct StoreOutput {
  template <class Lay>
  __device__ __forceinline__ void operator()(float2* dst, int k, int f, const Lay& ln,
                                             float2 v) const {
    dst[ln.at(k, f)] = v;
  }
};

// One Stockham pass of radix R after NS points of the n-point transform of
// every line: butterfly b of a line reads points b + r n / R, multiplies
// input r by e^{-2 pi i k r / (NS R)} (k = b mod NS) and writes its outputs
// to (b / NS) NS R + k + r NS through `out`.  `table` holds e^{-2 pi i j /
// tn} for a table length tn that n divides.  Work item u is (line f,
// butterfly b), u = b nf + f: the lanes of a warp take the same butterfly of
// consecutive lines.  A tile finds (f, b) by a mask and a shift; other
// lines step (f, k, q), b = q NS + k, by the block's threads from (t mod
// nf, t / nf), with no division a work item.
template <int R, class Lay, class Table, class Out>
__device__ __forceinline__ void mixed_pass(const float2* __restrict__ src, float2* __restrict__ dst,
                                           Table table, int tn, const Lay& ln, int NS,
                                           const Out& out) {
  const int nb = ln.n / R;
  const int step = tn / (NS * R);
  float2 cs[R / 2 + 1];
  if constexpr (R % 2 == 1) {
#pragma unroll
    for (int m = 1; m <= R / 2; ++m) cs[m] = table_at(table, m * (tn / R));
  }
  auto butterfly_at = [&](int f, int b, int q, int k) {
    float2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = src[ln.at(b + r * nb, f)];
    if (k > 0) {
#pragma unroll
      for (int r = 1; r < R; ++r) v[r] = cmul(v[r], table_at(table, step * k * r));
    }
    butterfly<R>(v, cs);
    const int o = q * NS * R + k;
    if constexpr (std::is_same<Out, StoreOutput>::value) {
#pragma unroll
      for (int r = 0; r < R; ++r) dst[ln.at(o + r * NS, f)] = v[r];
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) out(dst, o + r * NS, f, ln, v[r]);
    }
  };
  if constexpr (std::is_same<Lay, Tile>::value) {
    const int work = nb << ln.lg, fmask = (1 << ln.lg) - 1;
    for (int u = threadIdx.x; u < work; u += blockDim.x) {
      const int b = u >> ln.lg, q = b / NS;
      butterfly_at(u & fmask, b, q, b - q * NS);
    }
  } else {
    const int work = nb * ln.nf;
    const int nf = ln.nf, t = threadIdx.x / nf, bt = blockDim.x / nf;
    int f = threadIdx.x - t * nf, k = t % NS, q = t / NS;
    const int df = blockDim.x - bt * nf, dk = bt % NS, dq = bt / NS;
    for (int u = threadIdx.x; u < work; u += blockDim.x) {
      butterfly_at(f, q * NS + k, q, k);
      f += df;
      k += dk;
      q += dq;
      if (f >= nf) {
        f -= nf;
        ++k;
      }
      if (k >= NS) {
        k -= NS;
        ++q;
      }
    }
  }
}

// The pass of radix R of the plan (lines_fft's instantiation kW).
template <int kW, class Lay, class Table, class Out>
__device__ __forceinline__ void pass_of(int R, const float2* a, float2* b, Table table, int tn,
                                        const Lay& ln, int NS, const Out& out) {
  switch (R) {
    case 2: mixed_pass<2>(a, b, table, tn, ln, NS, out); break;
    case 3: mixed_pass<3>(a, b, table, tn, ln, NS, out); break;
    case 4: mixed_pass<4>(a, b, table, tn, ln, NS, out); break;
    case 5: mixed_pass<5>(a, b, table, tn, ln, NS, out); break;
    case 7: mixed_pass<7>(a, b, table, tn, ln, NS, out); break;
    case 8: mixed_pass<8>(a, b, table, tn, ln, NS, out); break;
    default:
      if constexpr (kW >= 13) {
        switch (R) {
          case 11: mixed_pass<11>(a, b, table, tn, ln, NS, out); break;
          case 13: mixed_pass<13>(a, b, table, tn, ln, NS, out); break;
          default:
            if constexpr (kW >= 31) {
              switch (R) {
                case 17: mixed_pass<17>(a, b, table, tn, ln, NS, out); break;
                case 19: mixed_pass<19>(a, b, table, tn, ln, NS, out); break;
                case 23: mixed_pass<23>(a, b, table, tn, ln, NS, out); break;
                case 29: mixed_pass<29>(a, b, table, tn, ln, NS, out); break;
                default: mixed_pass<31>(a, b, table, tn, ln, NS, out); break;
              }
            }
        }
      }
  }
}

// The transform of every line in `a`; `b` is the other buffer; `table`
// holds e^{-2 pi i j / tn}, ln.n | tn.  Every thread of the block calls it;
// returns the buffer that holds the result, in natural order (where the
// last pass's `last` stores it, as StoreOutput does).  kW is the plan's
// width (plan_width): the primes above kW are not instantiated.
template <int kW, class Lay, class Last = StoreOutput, class Table = const float2*>
__device__ float2* lines_fft(float2* a, float2* b, Table table, int tn, const Lay& ln,
                             const MixedPlan& plan, const Last& last = Last{}) {
  int NS = 1;
  for (int p = 0; p < plan.n_pass; ++p) {
    const int R = plan.radix[p];
    if constexpr (std::is_same<Last, StoreOutput>::value) {
      pass_of<kW>(R, a, b, table, tn, ln, NS, last);
    } else if (p + 1 < plan.n_pass) {
      pass_of<kW>(R, a, b, table, tn, ln, NS, StoreOutput{});
    } else {
      pass_of<kW>(R, a, b, table, tn, ln, NS, last);
    }
    __syncthreads();
    float2* const t = a;
    a = b;
    b = t;
    NS *= R;
  }
  return a;
}

// The M-point transform of a tile of 2^lg frames in `a` (point m of frame f
// at a[m * ld + f]), as lines_fft.
template <int kW, class Last = StoreOutput>
__device__ float2* mixed_fft(float2* a, float2* b, const float2* __restrict__ table, int tn,
                             int M, int lg, int ld, const MixedPlan& plan,
                             const Last& last = Last{}) {
  return lines_fft<kW>(a, b, table, tn, Tile{M, lg, ld}, plan, last);
}

// The row stride of a tile of ft frames: ft + 1, odd, so that a column walk
// over points is free of bank conflicts too; 1 for a single frame, whose
// points lie side by side.
__host__ __device__ inline int tile_ld(int ft) { return ft == 1 ? 1 : ft + 1; }

// float2 of one tile buffer: `rows` points of ft frames at row stride
// tile_ld(ft), rounded up to an even count so that the next buffer starts
// 16-byte aligned; a single frame's buffer holds two more, so that the
// samples staged in it (stage_run: len + 3 floats) always fit
__host__ __device__ inline int tile_elems(int rows, int ft) {
  return (rows * tile_ld(ft) + (ft == 1 ? 2 : 0) + 1) & ~1;
}

// Samples g0 .. g0 + len - 1 of a row of n_row samples (zero outside it)
// into shared memory at `dst` (16-byte aligned, len + 3 floats): 16-byte
// loads where the row allows, scalar ones at the ragged ends.  Returns p,
// p[i] = sample g0 + i.
__device__ __forceinline__ const float* stage_run(const float* __restrict__ xr, long long n_row,
                                                  long long g0, int len, float* dst) {
  const int a = (int)((4 - ((((uintptr_t)xr >> 2) + (unsigned long long)g0) & 3)) & 3);
  float* const p = dst + ((4 - a) & 3);  // p + a is 16-byte aligned, as xr + g0 + a is
  const int nv = len > a ? (len - a) >> 2 : 0;
  for (int c = threadIdx.x; c < nv; c += blockDim.x) {
    const long long s = g0 + a + 4LL * c;
    float4 v;
    if (s >= 0 && s + 4 <= n_row) {
      v = __ldg(reinterpret_cast<const float4*>(xr + s));
    } else {
      v.x = s >= 0 && s < n_row ? xr[s] : 0.f;
      v.y = s + 1 >= 0 && s + 1 < n_row ? xr[s + 1] : 0.f;
      v.z = s + 2 >= 0 && s + 2 < n_row ? xr[s + 2] : 0.f;
      v.w = s + 3 >= 0 && s + 3 < n_row ? xr[s + 3] : 0.f;
    }
    *reinterpret_cast<float4*>(p + a + 4 * c) = v;
  }
  const int t = threadIdx.x;
  if (t < 8) {  // the head (i < a) and the tail (i >= a + 4 nv): at most 3 each
    const int i = t < 4 ? t : a + 4 * nv + t - 4;
    if (i < len && (t >= 4 || i < a)) {
      const long long s = g0 + i;
      p[i] = s >= 0 && s < n_row ? xr[s] : 0.f;
    }
  }
  return p;
}

// The windowed, packed points of ft frames, frame f's samples at
// slab[f * sh ..]: buf[m * ld + f] = (w[2m] x[2m], w[2m+1] x[2m+1]).
__device__ __forceinline__ void pack_frames(const float* slab, int sh,
                                            const float* __restrict__ window, float2* buf, int M,
                                            int ft, int ld) {
  for (int i = threadIdx.x; i < ft * M; i += blockDim.x) {
    const int f = i / M, m = i - f * M;
    const float* const s = slab + f * sh + 2 * m;
    buf[m * ld + f] = make_float2(s[0] * __ldg(window + 2 * m), s[1] * __ldg(window + 2 * m + 1));
  }
}

}  // namespace
