// The four-step FFT of K1's global and split routes (spectrogram_power.cu)
// and K8's global frame pass (streaming.cu): an N-point transform past
// kOneBlockPoints, split as N = N1 N2 and run through two chunk buffers in
// global memory:
//
//   (1) N2 column transforms of N1 points,
//         Y[k1][n2] = sum_n1 x[N2 n1 + n2] e^{-2 pi i n1 k1 / N1};
//   (2) the twiddle Y'[k1][n2] = Y[k1][n2] e^{-2 pi i n2 k1 / N};
//   (3) N1 row transforms of N2 points,
//         X[k1 + N1 k2] = sum_n2 Y'[k1][n2] e^{-2 pi i n2 k2 / N2}.
//
// Steps 1 and 2 are one launch (the column transform applies the twiddle as
// it stores Y' into buffer A, row k1 at A[N2 k1 ..]), step 3 another (it
// reads A's rows and writes X in natural order through a Sink).  Each is
// mixed_fft.cuh's transform on a tile of 2^lg columns or rows, which it
// treats as its frames: a column tile loads runs of 2^lg neighbouring
// points of each row, a row tile whole rows, so both read and write device
// memory in runs.  N1 is the largest divisor of N up to sqrt(N), so N2 is
// the smallest that can be; the split is valid where both transforms have a
// plan and fit a block (four_step_of, mirrored by ops/spectrogram.py::
// four_step_plan).  Twiddles are a host table e^{-2 pi i j / tn}, N | tn.
//
// A Source gives point m of a chunk's frame f: the frame's windowed samples
// (packed in pairs for an even frame, one a point for an odd one) or a
// point of the chunk buffer, times the chirp where one is given, zero from
// point L on.  A Sink takes X[k]: as it is, or as the chirp-z transform
// needs it (below).  Every frame runs the same code in the same order,
// whichever chunk or launch it lies in.
//
// The chirp-z (Bluestein) transform of a complex length L over M points,
// of which the first K bins are wanted (K = L, or for an odd frame's power
// the F = (L + 1) / 2 bins of its half spectrum; M >= L + K - 1, 7-smooth:
// chirp_size_takes):
//   X[k] = c_k sum_j (z_j c_j) conj(c_{k-j}),  c_j = e^{-i pi j^2 / L},
// a circular convolution of a_j = z_j c_j (zero from L on) with b, b_m =
// conj(c_m) at m < K and at M - m, 0 < m < L, zero elsewhere: X = c .
// IFFT(FFT(a) . FFT(b)) for k < K (the lags k - j of those bins span L + K
// - 1 values, so M of them do not wrap onto each other), and the inverse
// as conj(FFT(conj(.))).  The host builds c (indexed by j^2 mod 2L in
// 64-bit integers) and Bt = FFT(b) / M in float64 and rounds both to
// float32: no sine on the card.  The forward transform's Sink stores
// conj(X Bt), the next transform's Source reads it, and its Sink stores
// conj(X) c (or conj(X) alone where only the power is wanted: |c_k| = 1).
//
// Rader's transform of a prime length L over R = L - 1 points (K1's
// Rader routes, spectrogram_power.cu): the Source reads point q of the
// frame at index gin[q] = g^q mod L, the first transform's Sink stores
// conj(A Bt) and keeps A_0, the second transform is plain.  For a real
// (odd) frame the first transform may run over R / 2 points of the packed
// pairs a_2m + i a_2m+1 (kOddPairs); its Sink keeps A_0 = Re U_0 + Im U_0,
// and the second transform's Source (kRaderSplit) forms each A_k from U_k
// and U_{R/2-k} by the real split before it multiplies by Bt.
//
// The split of a complex length L = P Q (K1's split route; split_of, P the
// one prime factor above kMaxPrime, Q with a plan): Cooley-Tukey's step
// with P's transform as the column transform, one block a tile of columns,
// by Rader's convolution over P - 1 points (rader_convolve) or the chirp-z
// transform over M points (chirp_convolve), each column read through a
// Column source; the column step (split_columns) stores Y'[k1][n2] (the
// twiddle e^{-2 pi i n2 k1 / L} applied, Rader's output permutation folded
// into the store), and four_step_rows runs the rows of Q points.  An odd
// frame is real: its columns go two as one complex column and part as they
// are stored, and only its rows k1 <= (P - 1) / 2 are kept and transformed,
// the others being their mirrors' conjugates.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "mixed_fft.cuh"

namespace {

constexpr int kStepThreads = 256;            // threads of a column or row block
constexpr int kBlockSmemLimit = 232448;      // dynamic shared memory a block may use
constexpr int kOneBlockPoints = 7264;        // the largest transform a route runs in one block
constexpr long long kChunkScratch = 1 << 25;  // bytes of the two chunk buffers together

// A column or row step: the transform of n points over tiles of 2^lg;
// lg < 0 where no tile fits.
struct StepPlan {
  int n, lg, smem;
  MixedPlan plan;
};

// Tiles of 2^lg frames (columns, rows) of an n-point transform: the largest
// power of two up to 32 whose two buffers fit a quarter of a block's shared
// memory (four blocks an SM), else one frame up to the whole limit
// (ops/spectrogram.py::tile_plan).
__host__ inline StepPlan step_plan(int n) {
  StepPlan s;
  s.n = n;
  s.plan = mixed_plan_of(n);
  s.lg = -1;
  s.smem = 0;
  for (int lg = 5; lg >= 0; --lg) {
    const long long bytes = 16LL * tile_elems(n, 1 << lg);
    if (bytes <= kBlockSmemLimit / 4 || (lg == 0 && bytes <= kBlockSmemLimit)) {
      s.lg = lg;
      s.smem = (int)bytes;
      break;
    }
  }
  return s;
}

struct FourStep {
  int N, N1, N2;
  StepPlan col, row;
  bool ok;
};

__host__ inline FourStep four_step_of(int N) {
  FourStep f;
  f.N = N;
  f.N1 = 1;
  for (int d = 1; (long long)d * d <= N; ++d)
    if (N % d == 0) f.N1 = d;
  f.N2 = N / f.N1;
  f.col = step_plan(f.N1);
  f.row = step_plan(f.N2);
  f.ok = N >= 4 && f.N1 >= 2 && f.col.plan.n_pass > 0 && f.row.plan.n_pass > 0 &&
         f.col.lg >= 0 && f.row.lg >= 0;
  return f;
}

__host__ inline bool seven_smooth(long long m) {
  if (m < 1) return false;
  const int primes[4] = {2, 3, 5, 7};
  for (int i = 0; i < 4; ++i)
    while (m % primes[i] == 0) m /= primes[i];
  return m == 1;
}

// Whether M points take the chirp-z transform of a complex length L whose
// first K bins are wanted (1 <= K <= L): M >= max(2, L + K - 1), M's only
// prime factors 2, 3, 5 and 7 (mixed_fft's narrow instantiation), and its
// transform one block holds or the four-step split takes.
// ops/spectrogram.py::chirp_size picks such an M.
__host__ inline bool chirp_size_takes(int L, int K, int M) {
  const long long lo = (long long)L + K - 1 > 2 ? (long long)L + K - 1 : 2;
  return L >= 1 && K >= 1 && K <= L && M >= lo && seven_smooth(M) &&
         mixed_plan_of(M).n_pass > 0 && (M <= kOneBlockPoints || four_step_of(M).ok);
}

// Frames a chunk of the global route holds: as many as the two buffers of
// N points each hold within kChunkScratch, at least one
__host__ inline long long chunk_frames(int N, long long frames) {
  long long c = kChunkScratch / (16LL * N);
  if (c < 1) c = 1;
  return c < frames ? c : frames;
}

struct Source {
  enum Mode { kEvenFrame = 0, kOddFrame = 1, kBuffer = 2, kOddPairs = 3, kRaderSplit = 4 };
  int mode;
  // kEvenFrame / kOddFrame / kOddPairs: frame g0 + f is frame t of row b,
  // g = b T + t, its samples x[b][t hop - pad ..] (zero outside the row),
  // windowed by point: point m's samples (2m and 2m + 1, or m) times
  // window[2m], window[2m + 1] (or window[m]), so a permuted gather reads
  // its window in order from a permuted table
  const float* x;
  long long row_len, g0;
  int T, hop, pad;
  const float* window;
  // kBuffer: point m of frame f at buf[f * stride + m]
  const float2* buf;
  long long stride;
  const float2* chirp;  // points times chirp[m] where given
  int L;                // points from L on are zero
  // Rader's routes: kEvenFrame / kOddFrame take point m from the frame's
  // complex index gin[m] where given; kOddPairs packs the real points
  // gin[2m] and gin[2m + 1].  The window is then the permuted one
  // (ops/spectrogram.py::rader_window).
  const int* gin = nullptr;
  // kRaderSplit: buf holds U, the half-length transform of a real sequence
  // a (half points); point m is conj(A_m bt[m]), A_m = E + tw[m] O from
  // U_{m mod half} and U_{half - m mod half}, tw[m] = e^{-2 pi i m / (2 half)}
  const float2* bt = nullptr;
  const float2* tw = nullptr;
  int half = 0;

  // frame g0 + f: its row and the row's index of its first sample
  struct Origin {
    const float* xr;
    long long s;
  };
  __device__ __forceinline__ Origin frame_origin(long long f) const {
    const long long g = g0 + f, b = g / T;
    return {x + b * row_len, (g - b * T) * hop - pad};
  }
  // the frame's sample j times window[w], zero outside the row
  __device__ __forceinline__ float sample(const Origin& o, long long j, int w) const {
    const long long s0 = o.s + j;
    return (s0 >= 0 && s0 < row_len ? o.xr[s0] : 0.f) * __ldg(window + w);
  }

  __device__ __forceinline__ float2 operator()(int f, int m) const {
    if (m >= L) return make_float2(0.f, 0.f);
    float2 v;
    if (mode == kBuffer) {
      v = buf[f * stride + m];
    } else if (mode == kRaderSplit) {
      const float2* const u = buf + f * stride;
      const int k = m < half ? m : m - half;
      const float2 zk = u[k], zm = u[k == 0 ? 0 : half - k];
      const float ar = 0.5f * (zk.x + zm.x), ai = 0.5f * (zk.y - zm.y);
      const float dr = 0.5f * (zk.x - zm.x), di = 0.5f * (zk.y + zm.y);
      const float2 w = __ldg(tw + m);
      v = cmul(make_float2(ar + (w.x * di + w.y * dr), ai - (w.x * dr - w.y * di)),
               __ldg(bt + m));
      v.y = -v.y;
    } else {
      const Origin o = frame_origin(f);
      auto at = [&](long long j, int w) { return sample(o, j, w); };
      if (mode == kOddPairs) {
        v = make_float2(at(__ldg(gin + 2 * m), 2 * m), at(__ldg(gin + 2 * m + 1), 2 * m + 1));
      } else {
        const long long j = gin != nullptr ? __ldg(gin + m) : m;
        v = mode == kEvenFrame ? make_float2(at(2 * j, 2 * m), at(2 * j + 1, 2 * m + 1))
                               : make_float2(at(j, m), 0.f);
      }
    }
    if (chirp != nullptr) v = cmul(v, __ldg(chirp + m));
    return v;
  }
};

// The split route's column source.  Column n2 of a frame holds its points
// n = Q n1 + n2, n1 < P; an odd frame's columns are real, so with `pairs`
// columns n2 = 2p and 2p + 1 go as one complex column p (the second zero
// where Q is odd and 2p + 1 = Q), ceil(Q / 2) a frame.  Point m in the
// column transform's input order: Rader's gather reads n1 = gin[m] (m < P -
// 1), the chirp-z transform n1 = m times chirp[m], zero from P on.  A
// thread locates its column once (Source::frame_origin) and reads its
// points through Source::sample.
struct Column {
  Source frame;  // the frames' samples: mode kEvenFrame or kOddFrame, x, rows, window
  int P, Q;
  bool pairs;
  const int* gin;       // Rader: g^m mod P
  const float2* chirp;  // the chirp-z transform: c_m = e^{-i pi m^2 / P}, m < P

  struct At {
    Source::Origin o;
    int n2;  // the column (the first of a pair)
    bool live, second;
  };

  __device__ __forceinline__ int per_frame() const { return pairs ? (Q + 1) / 2 : Q; }
  // column c of the chunk: frame c / per_frame(), its column c mod per_frame()
  __device__ __forceinline__ At locate(int c, int n_cols) const {
    At a{{frame.x, 0}, 0, c < n_cols, false};
    if (!a.live) return a;
    const int cq = per_frame(), f = c / cq, p = c - f * cq;
    a.n2 = pairs ? 2 * p : p;
    a.second = pairs && a.n2 + 1 < Q;
    a.o = frame.frame_origin(f);
    return a;
  }
  // the column's point n1 (a pair's two real points as one)
  __device__ __forceinline__ float2 point(const At& a, int n1) const {
    const int n = Q * n1 + a.n2;
    if (frame.mode == Source::kEvenFrame)
      return make_float2(frame.sample(a.o, 2 * n, 2 * n), frame.sample(a.o, 2 * n + 1, 2 * n + 1));
    return make_float2(frame.sample(a.o, n, n), a.second ? frame.sample(a.o, n + 1, n + 1) : 0.f);
  }
  __device__ __forceinline__ float2 operator()(const At& a, int m) const {
    if (!a.live) return make_float2(0.f, 0.f);
    if (gin != nullptr) return point(a, __ldg(gin + m));
    if (m >= P) return make_float2(0.f, 0.f);
    return cmul(point(a, m), __ldg(chirp + m));
  }
};

struct Sink {
  enum Mode { kPlain = 0, kChirpForward = 1, kChirpInverse = 2, kRaderForward = 3,
              kRaderHalf = 4 };
  int mode;
  float2* buf;  // X[k] of frame f at buf[f * stride + k]
  long long stride;
  const float2* bt;     // kChirpForward, kRaderForward: conj(X Bt)
  const float2* chirp;  // kChirpInverse: conj(X) chirp[k] (conj(X) where null), k < L
  int L;
  // kRaderForward: a0[f] = X_0 (then as kChirpForward); kRaderHalf: a0[f] =
  // Re X_0 + Im X_0, the real sequence's sum (then as kPlain)
  float2* a0 = nullptr;

  __device__ __forceinline__ void operator()(int f, int k, float2 v) const {
    if (mode == kRaderForward || mode == kRaderHalf) {
      if (k == 0) a0[f] = mode == kRaderHalf ? make_float2(v.x + v.y, 0.f) : v;
      if (mode == kRaderHalf) {
        buf[f * stride + k] = v;
        return;
      }
    }
    if (mode == kChirpForward || mode == kRaderForward) {
      v = cmul(v, __ldg(bt + k));
      v.y = -v.y;
    } else if (mode == kChirpInverse) {
      if (k >= L) return;
      v.y = -v.y;
      if (chirp != nullptr) v = cmul(v, __ldg(chirp + k));
    }
    buf[f * stride + k] = v;
  }
};

// K1's power of bin k < M of an even frame from its half-length transform Z:
// zk = Z[k], zm = Z[M - k] (Z[0] at k = 0), w = e^{-2 pi i k / n_fft};
// and of bin M from Z[0] (spectrogram_power.cu, spectrogram_cluster.cu).
__device__ __forceinline__ float split_power(float2 zk, float2 zm, float2 w) {
  const float ar = 0.5f * (zk.x + zm.x), ai = 0.5f * (zk.y - zm.y);
  const float dr = 0.5f * (zk.x - zm.x), di = 0.5f * (zk.y + zm.y);
  const float xr = ar + (w.x * di + w.y * dr);
  const float xi = ai - (w.x * dr - w.y * di);
  return xr * xr + xi * xi;
}
__device__ __forceinline__ float nyquist_power(float2 z0) {
  const float d = z0.x - z0.y;
  return d * d;
}

template <int kW>
__global__ void __launch_bounds__(kStepThreads)
four_step_columns(Source src, float2* __restrict__ dst, const float2* __restrict__ table, int tn,
                  int N, int N1, int N2, int lg, int n_tiles, MixedPlan plan) {
  extern __shared__ float4 smem4[];
  const int ft = 1 << lg, ld = tile_ld(ft);
  float2* const a = reinterpret_cast<float2*>(smem4);
  float2* const b = a + tile_elems(N1, ft);
  const int f = blockIdx.x / n_tiles;
  const int c0 = (blockIdx.x - f * n_tiles) << lg;
  for (int i = threadIdx.x; i < (N1 << lg); i += blockDim.x) {
    const int n1 = i >> lg, j = i & (ft - 1);
    a[n1 * ld + j] = c0 + j < N2 ? src(f, N2 * n1 + c0 + j) : make_float2(0.f, 0.f);
  }
  __syncthreads();
  const float2* const Y = mixed_fft<kW>(a, b, table, tn, N1, lg, ld, plan);
  const long long step = tn / N;
  float2* const out = dst + (long long)f * N;
  for (int i = threadIdx.x; i < (N1 << lg); i += blockDim.x) {
    const int k1 = i >> lg, j = i & (ft - 1), n2 = c0 + j;
    if (n2 >= N2) continue;
    float2 v = Y[k1 * ld + j];
    if (k1 > 0 && n2 > 0) v = cmul(v, __ldg(table + step * n2 * k1));
    out[(long long)N2 * k1 + n2] = v;
  }
}

template <int kW>
__global__ void __launch_bounds__(kStepThreads)
four_step_rows(const float2* __restrict__ src, Sink snk, const float2* __restrict__ table, int tn,
               int N, int N1, int N2, int lg, int n_tiles, MixedPlan plan) {
  extern __shared__ float4 smem4[];
  const int ft = 1 << lg, ld = tile_ld(ft);
  float2* const a = reinterpret_cast<float2*>(smem4);
  float2* const b = a + tile_elems(N2, ft);
  const int f = blockIdx.x / n_tiles;
  const int r0 = (blockIdx.x - f * n_tiles) << lg;
  const float2* const in = src + (long long)f * N;
  for (int i = threadIdx.x; i < (N2 << lg); i += blockDim.x) {
    const int j = i / N2, n2 = i - j * N2;
    a[n2 * ld + j] = r0 + j < N1 ? in[(long long)N2 * (r0 + j) + n2] : make_float2(0.f, 0.f);
  }
  __syncthreads();
  const float2* const Y = mixed_fft<kW>(a, b, table, tn, N2, lg, ld, plan);
  for (int i = threadIdx.x; i < (N2 << lg); i += blockDim.x) {
    const int k2 = i >> lg, j = i & (ft - 1);
    if (r0 + j < N1) snk(f, r0 + j + N1 * k2, Y[k2 * ld + j]);
  }
}

// The chirp-z convolution of a tile in shared memory (point m of frame f at
// a[m * ld + f]: the frame times the chirp, zero-padded to M points): the
// M-point transform, times Bt and conjugated, the transform again; b is the
// other buffer.  Returns the buffer holding W, whose conj(W[k]) c_k is X[k].
// M is 7-smooth: no wide prime.
__device__ __forceinline__ float2* chirp_convolve(float2* a, float2* b,
                                                  const float2* __restrict__ ctab,
                                                  const float2* __restrict__ bt, int M, int lg,
                                                  int ld, const MixedPlan& plan) {
  float2* const Y = mixed_fft<7>(a, b, ctab, M, M, lg, ld, plan);
  for (int i = threadIdx.x; i < (M << lg); i += blockDim.x) {
    const int k = i >> lg, j = k * ld + (i & ((1 << lg) - 1));
    const float2 v = cmul(Y[j], __ldg(bt + k));
    Y[j] = make_float2(v.x, -v.y);
  }
  __syncthreads();
  return mixed_fft<7>(Y, Y == a ? b : a, ctab, M, M, lg, ld, plan);
}

// Rader's cyclic convolution of a tile in shared memory (point q of frame f
// at a[q * ld + f]: a_q = z[g^q], R = L - 1 points of a prime L): the
// R-point transform, whose bin 0 goes to a0[f] (A_0), times Bt and
// conjugated, the transform again; b is the other buffer.  Returns the
// buffer holding W: X[g^-q] = z_0 + conj(W[q]) and X_0 = z_0 + A_0.
template <int kW>
__device__ __forceinline__ float2* rader_convolve(float2* a, float2* b,
                                                  const float2* __restrict__ rtab,
                                                  const float2* __restrict__ bt, float2* a0, int R,
                                                  int lg, int ld, const MixedPlan& plan) {
  float2* const Y = mixed_fft<kW>(a, b, rtab, R, R, lg, ld, plan);
  for (int i = threadIdx.x; i < (R << lg); i += blockDim.x) {
    const int k = i >> lg, f = i & ((1 << lg) - 1), j = k * ld + f;
    if (k == 0) a0[f] = Y[j];
    const float2 v = cmul(Y[j], __ldg(bt + k));
    Y[j] = make_float2(v.x, -v.y);
  }
  __syncthreads();
  return mixed_fft<kW>(Y, Y == a ? b : a, rtab, R, R, lg, ld, plan);
}

// The split route's row step: Q points a row, tiles of the largest power
// of two up to 256 rows whose two buffers fit a quarter of a block's shared
// memory (step_plan's rule past its 32: a block of 32 rows of few points
// has little work), else one row up to the whole limit
// (ops/spectrogram.py::split_row_plan).
__host__ inline StepPlan split_row_step(int Q) {
  StepPlan s = step_plan(Q);
  for (int lg = 8; lg > 5; --lg) {
    const long long bytes = 16LL * tile_elems(Q, 1 << lg);
    if (bytes <= kBlockSmemLimit / 4) {
      s.lg = lg;
      s.smem = (int)bytes;
      break;
    }
  }
  return s;
}

// The split route's factors of a complex length L (ops/spectrogram.py::
// split_plan): P its only prime factor above kMaxPrime, dividing L once;
// Q = L / P >= 2 with a plan of at most kOneBlockPoints points; P's column
// transform by Rader's convolution over P - 1 points where P - 1 has a
// plan of at most kOneBlockPoints points (rader), else by the chirp-z
// transform over a size M the launcher checks (chirp_size_takes(P, P, M),
// M <= kOneBlockPoints).
struct Split {
  int P, Q;
  bool rader, ok;
};

__host__ inline Split split_of(int L) {
  Split s{0, 0, false, false};
  int q = L, n_big = 0;
  for (int d = 2; (long long)d * d <= q; ++d) {
    while (q % d == 0) {
      if (d > kMaxPrime) {
        s.P = d;
        ++n_big;
      }
      q /= d;
    }
  }
  if (q > kMaxPrime) {
    s.P = q;
    ++n_big;
  }
  if (n_big != 1) return s;
  s.Q = L / s.P;
  s.rader = s.P - 1 <= kOneBlockPoints && mixed_plan_of(s.P - 1).n_pass > 0;
  s.ok = s.Q >= 2 && s.Q <= kOneBlockPoints && mixed_plan_of(s.Q).n_pass > 0;
  return s;
}

// The split route's column step: a block transforms a tile of 2^lg columns
// of the chunk's n_cols (column c is column c mod per_frame() of the
// chunk's frame c / per_frame(), so a tile spans frames where Q is small)
// by Rader's convolution over M = P - 1 points (kRader) or the chirp-z
// transform over M points (ftab e^{-2 pi i j / M}, bt FFT(b) / M), and
// stores each column's outputs X[k1] as Y'[k1][n2] = X[k1] e^{-2 pi i n2 k1
// / L} (twiddle: e^{-2 pi i j / tn}, L | tn)
// at dst[f S + Q k1 + n2]: row k1 of the frame's rows.  A pair's two real
// columns come apart as they are stored, X_a = (Z[k1] + conj(Z[P - k1])) / 2
// and X_b = (Z[k1] - conj(Z[P - k1])) / 2i, and only rows k1 <= (P - 1) / 2
// are kept (the rest are their mirrors' conjugates): S = ((P + 1) / 2) Q,
// else S = L.
template <int kW, bool kRader>
__global__ void __launch_bounds__(kStepThreads)
split_columns(Column col, float2* __restrict__ dst, const float2* __restrict__ ftab,
              const float2* __restrict__ bt, const float2* __restrict__ twiddle, int tn, int M,
              int lg, int n_cols, MixedPlan plan) {
  extern __shared__ float4 smem4[];
  const int ft = 1 << lg, ld = tile_ld(ft), P = col.P, Q = col.Q, L = P * Q;
  const int H = col.pairs ? (P - 1) / 2 : P - 1;  // the last row kept
  const long long S = (long long)(H + 1) * Q;     // points a frame of dst
  float2* const z0 = reinterpret_cast<float2*>(smem4);  // Rader: [ft] each column's z_0
  float2* const a0 = z0 + (kRader ? ft : 0);            // Rader: [ft] each column's A_0
  float2* const buf_a = a0 + (kRader ? ft : 0);
  float2* const buf_b = buf_a + tile_elems(M, ft);
  const int c0 = blockIdx.x << lg;
  {
    // a thread's column is the same in every round: blockDim.x is a multiple of 2^lg
    const int j = threadIdx.x & (ft - 1);
    const Column::At at = col.locate(c0 + j, n_cols);
    for (int i = threadIdx.x; i < (M << lg); i += blockDim.x)
      buf_a[(i >> lg) * ld + j] = col(at, i >> lg);
  }
  if constexpr (kRader) {
    for (int j = threadIdx.x; j < ft; j += blockDim.x) {
      const Column::At at = col.locate(c0 + j, n_cols);
      z0[j] = at.live ? col.point(at, 0) : make_float2(0.f, 0.f);
    }
  }
  __syncthreads();
  const float2* W;
  if constexpr (kRader) {
    W = rader_convolve<kW>(buf_a, buf_b, ftab, bt, a0, M, lg, ld, plan);
  } else {
    W = chirp_convolve(buf_a, buf_b, ftab, bt, M, lg, ld, plan);
  }
  // Z[k1] of column j from output q: Rader's X[g^-q] = z_0 + conj(W[q]) (q < M)
  // and X_0 = z_0 + A_0 (q = M); the chirp-z transform's conj(W[q]) c_q, q < P
  auto Z = [&](int q, int j) {
    if constexpr (kRader) {
      const float2 z = z0[j], w = q < M ? W[q * ld + j] : a0[j];
      return make_float2(z.x + w.x, q < M ? z.y - w.y : z.y + w.y);
    } else {
      const float2 w = W[q * ld + j];
      return cmul(make_float2(w.x, -w.y), __ldg(col.chirp + q));
    }
  };
  const int step = tn / L, cq = col.per_frame();
  for (int i = threadIdx.x; i < (P << lg); i += blockDim.x) {
    const int q = i >> lg, j = i & (ft - 1), c = c0 + j;
    // Rader's output q is bin g^-q, g^-q = gin[M - q]; its mirror P - g^-q
    // is output q + M / 2 (g^(M/2) = -1)
    const int k1 = kRader ? (q < M ? __ldg(col.gin + (q == 0 ? 0 : M - q)) : 0) : q;
    if (c >= n_cols || k1 > H) continue;
    const int f = c / cq, p = c - f * cq;
    float2* const row = dst + f * S + (long long)Q * k1;
    auto store = [&](int n2, float2 v) {
      if (k1 > 0 && n2 > 0) v = cmul(v, __ldg(twiddle + step * n2 * k1));
      row[n2] = v;
    };
    const float2 v = Z(q, j);
    if (!col.pairs) {
      store(p, v);
      continue;
    }
    const int qm = kRader ? (q < M ? (q + M / 2) % M : M) : (k1 == 0 ? 0 : P - k1);
    const float2 w = Z(qm, j);
    store(2 * p, make_float2(0.5f * (v.x + w.x), 0.5f * (v.y - w.y)));
    if (2 * p + 1 < Q) store(2 * p + 1, make_float2(0.5f * (v.y + w.y), 0.5f * (w.x - v.x)));
  }
}

// Let `kernel` take `bytes` of dynamic shared memory on the current device;
// `dev_set` and `smem_set` remember what was set last, per kernel.
inline cudaError_t raise_smem_to(const void* kernel, int bytes, int& dev_set, int& smem_set) {
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

template <int kW>
cudaError_t launch_columns(const Source& src, float2* dst, const float2* table, int tn,
                           const FourStep& fs, int frames, cudaStream_t s) {
  static int dev_set = -1, smem_set = 0;
  const void* kernel = (const void*)four_step_columns<kW>;
  const cudaError_t err = raise_smem_to(kernel, fs.col.smem, dev_set, smem_set);
  if (err != cudaSuccess) return err;
  const int n_tiles = (fs.N2 + (1 << fs.col.lg) - 1) >> fs.col.lg;
  if ((long long)frames * n_tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  four_step_columns<kW><<<frames * n_tiles, kStepThreads, fs.col.smem, s>>>(
      src, dst, table, tn, fs.N, fs.N1, fs.N2, fs.col.lg, n_tiles, fs.col.plan);
  return cudaGetLastError();
}

template <int kW>
cudaError_t launch_rows(const float2* src, const Sink& snk, const float2* table, int tn,
                        const FourStep& fs, int frames, cudaStream_t s) {
  static int dev_set = -1, smem_set = 0;
  const void* kernel = (const void*)four_step_rows<kW>;
  const cudaError_t err = raise_smem_to(kernel, fs.row.smem, dev_set, smem_set);
  if (err != cudaSuccess) return err;
  const int n_tiles = (fs.N1 + (1 << fs.row.lg) - 1) >> fs.row.lg;
  if ((long long)frames * n_tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  four_step_rows<kW><<<frames * n_tiles, kStepThreads, fs.row.smem, s>>>(
      src, snk, table, tn, fs.N, fs.N1, fs.N2, fs.row.lg, n_tiles, fs.row.plan);
  return cudaGetLastError();
}

// The split route's column step over n_cols columns, 2^lg a block in smem
// bytes (split_columns).
template <int kW, bool kRader>
cudaError_t launch_split_columns(const Column& col, float2* dst, const float2* ftab,
                                 const float2* bt, const float2* twiddle, int tn, int M, int lg,
                                 int smem, int n_cols, const MixedPlan& plan, cudaStream_t s) {
  static int dev_set = -1, smem_set = 0;
  const void* kernel = (const void*)split_columns<kW, kRader>;
  const cudaError_t err = raise_smem_to(kernel, smem, dev_set, smem_set);
  if (err != cudaSuccess) return err;
  const int grid = (n_cols + (1 << lg) - 1) >> lg;
  split_columns<kW, kRader><<<grid, kStepThreads, smem, s>>>(col, dst, ftab, bt, twiddle, tn, M,
                                                             lg, n_cols, plan);
  return cudaGetLastError();
}

// The N-point transform of `frames` frames from `src` into `snk`, through
// buffer A (frames x N points): two launches.
inline cudaError_t four_step(const Source& src, const Sink& snk, float2* A, const float2* table,
                             int tn, const FourStep& fs, int frames, cudaStream_t s) {
  const cudaError_t err = by_width(fs.col.plan, [&](auto w) {
    return launch_columns<decltype(w)::value>(src, A, table, tn, fs, frames, s);
  });
  if (err != cudaSuccess) return err;
  return by_width(fs.row.plan, [&](auto w) {
    return launch_rows<decltype(w)::value>(A, snk, table, tn, fs, frames, s);
  });
}

// The transform of a chunk's frames of complex length L through N points
// (N == L: one four-step FFT; else the chirp-z transform: two), ending in
// buffer B as X[k], k < L (times the chirp where `post`, which the chirp-z
// route's power does not need).  `src` reads the frames; chirp, bt and the
// table of N describe the chirp-z transform (chirp null: N == L).
inline cudaError_t transform_chunk(Source src, float2* A, float2* B, const float2* table, int tn,
                                   const float2* chirp, const float2* bt, int L, bool post,
                                   const FourStep& fs, int frames, cudaStream_t s) {
  Sink snk{Sink::kPlain, B, fs.N, nullptr, nullptr, L};
  if (chirp == nullptr) return four_step(src, snk, A, table, tn, fs, frames, s);
  src.chirp = chirp;
  src.L = L;
  snk.mode = Sink::kChirpForward;
  snk.bt = bt;
  cudaError_t err = four_step(src, snk, A, table, tn, fs, frames, s);
  if (err != cudaSuccess) return err;
  Source mid{Source::kBuffer, nullptr, 0, 0, 1, 0, 0, nullptr, B, fs.N, nullptr, fs.N};
  snk.mode = Sink::kChirpInverse;
  snk.chirp = post ? chirp : nullptr;
  return four_step(mid, snk, A, table, tn, fs, frames, s);
}

}  // namespace
