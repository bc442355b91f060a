// K1's cluster route (apt_spectrogram_power_cluster): the whole chirp-z
// (Bluestein) transform of a frame kept on chip, for the complex lengths L
// (n_fft / 2 packed in pairs, or n_fft) whose chirp-z size M passes one
// block of the one-block chirp-z route (kOneBlockPoints) and that neither
// Rader's routes nor the split route take: L prime with no Rader plan
// (7,013), two primes above 31 (7,003 = 47 x 149), P squared (7,396: L = 2 x
// 43^2), P too large for one block (10,821 = 3 x 3,607).  Part of K1, which
// replaces the Pallas kernel `_power_kernel`
// (audio_processing_tools_tpu/ops/spectrogram.py:77-96, pallas_call at
// :126); the TPU kernel takes none of these sizes, its DFT-as-matrix-product
// being the transform (four_step.cuh states the chirp-z transform).
//
// One frame a cluster of C blocks (C = 1, 2, 4 or 8, one block an SM), M =
// N1 N2 with C | N1 and C | N2 (cluster_fft.cuh; ops/spectrogram.py::
// cluster_plan picks C and M):
//   block r loads its N2 / C columns (n = N2 n1 + n2) straight from the clip
//   through Source's sampling (the window, packed pairs for an even frame),
//   times the chirp, zero from L on; the columns' N1-point transforms, the
//   twiddle e^{-2 pi i n2 k1 / M} at their last store; the exchange to N1 / C
//   rows; the rows' N2-point transforms, conj(X Bt) at their last store; the
//   inverse as the transposed four-step (conj(FFT(conj(.)))): the rows'
//   transforms again, the twiddle e^{-2 pi i k1 m2 / M}; the exchange back
//   to columns; the columns' transforms, W[m2 + N2 m1].  An odd frame's
//   power |W_k|^2 (|c_k| = 1) of its F bins goes out from the last pass's
//   registers; an even frame's bin k pairs Z_k = conj(W_k) c_k with Z_{L-k},
//   read from the block that holds it through distributed shared memory.
// Device memory sees the frame's samples going in and its F powers going
// out: two exchanges and no round trip of the frame's M points, where the
// chirp-z global route (four_step.cuh, five launches a 32 MiB chunk) moves
// each frame's points through device memory about five times.
//
// What bounds it: the function's bytes, samples in and power out (~0.034 ms
// at 128 x 10 s and 3.35 TB/s); the route's own cost is shared memory, two
// M-point transforms a frame (~12 passes over M points, read and written),
// with the tables (chirp, Bt, twiddles of M: host float64 rounded to
// float32, no sine on the card) read through L1 and L2.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cluster_fft.cuh"

namespace {

template <int C>
__global__ void __launch_bounds__(kClusterThreads, 1)
spectrogram_power_cluster(Source src, const float2* __restrict__ chirp,
                          const float2* __restrict__ bt, const float2* __restrict__ ctab,
                          const float2* __restrict__ twiddle, float* __restrict__ out, int T,
                          int F, int even, ClusterSplit s, MixedPlan plan1, MixedPlan plan2) {
  extern __shared__ float4 smem4[];
  float2* const buf_a = reinterpret_cast<float2*>(smem4);
  float2* const buf_b = buf_a + s.elems;
  int r = 0;
  if constexpr (C > 1) r = (int)cg::this_cluster().block_rank();
  const long long frame = blockIdx.x / C;
  const int L = src.L;
  const Source::Origin o = src.frame_origin(frame);
  const ClusterTables tabs = load_tables(buf_b + s.elems, s, ctab);
  copy_in_flight(
      s.N1 * s.nc,
      [&](int e) {
        const int n1 = s.by_nc(e);
        const int n = s.N2 * n1 + r * s.nc + e - n1 * s.nc;
        float2 v = make_float2(0.f, 0.f);
        if (n < L) {
          v = even ? make_float2(src.sample(o, 2LL * n, 2 * n),
                                 src.sample(o, 2LL * n + 1, 2 * n + 1))
                   : make_float2(src.sample(o, n, n), 0.f);
          v = cmul(v, __ldg(chirp + n));
        }
        return v;
      },
      [&](int e, float2 v) {
        const int n1 = s.by_nc(e);
        buf_a[n1 * s.ldc + e - n1 * s.nc] = v;
      });
  __syncthreads();
  const Lines cols{s.N1, s.nc, s.ldc, 1}, rows{s.N2, s.nr, 1, s.ldr};
  auto other = [&](const float2* p) { return p == buf_a ? buf_b : buf_a; };
  const SharedTable t1{tabs.t1}, t2{tabs.t2};
  float2* y = lines_fft<7>(buf_a, buf_b, t1, s.N1, cols, plan1,
                           LastOut{LastOut::kTwiddle, r * s.nc, 0, tabs});
  if constexpr (C > 1) {
    gather_rows(y, other(y), s, r);
    y = other(y);
  }
  y = lines_fft<7>(y, other(y), t2, s.N2, rows, plan2,
                   LastOut{LastOut::kConjBt, r * s.nr, s.N1, tabs, bt});
  y = lines_fft<7>(y, other(y), t2, s.N2, rows, plan2,
                   LastOut{LastOut::kTwiddle, r * s.nr, 0, tabs});
  if constexpr (C > 1) {
    gather_columns(y, other(y), s, r);
    y = other(y);
  }
  const long long b = frame / T;
  float* const po = out + b * F * T + (frame - b * T);  // bin k at po[k T]
  if (!even) {
    lines_fft<7>(y, other(y), t1, s.N1, cols, plan1,
                 LastOut{LastOut::kPower, r * s.nc, s.N2, tabs, nullptr, po, F, T});
    return;
  }
  const float2* const w =
      lines_fft<7>(y, other(y), t1, s.N1, cols, plan1, LastOut{LastOut::kStore, 0, 0, tabs});
  if constexpr (C > 1) cg::this_cluster().sync();  // every block's W before a partner is read
  copy_in_flight(
      s.N1 * s.nc,
      [&](int e) {
        const int m1 = s.by_nc(e), j = e - m1 * s.nc;
        const int k = r * s.nc + j + s.N2 * m1;
        if (k >= L) return 0.f;
        // bin k pairs with L - k: column (L - k) mod N2 of block ((L - k) mod N2) / nc
        const int p = k == 0 ? 0 : L - k, pr = s.by_N2(p), pc = p - pr * s.N2, pb = s.by_nc(pc);
        const float2* wp = w;
        if constexpr (C > 1) wp = cg::this_cluster().map_shared_rank(w, pb);
        const float2 wk = w[m1 * s.ldc + j], wm = wp[pr * s.ldc + pc - pb * s.nc];
        const float2 zk = cmul(make_float2(wk.x, -wk.y), __ldg(chirp + k));
        const float2 zm = cmul(make_float2(wm.x, -wm.y), __ldg(chirp + p));
        return split_power(zk, zm, __ldg(twiddle + k));
      },
      [&](int e, float v) {
        const int m1 = s.by_nc(e);
        const int k = r * s.nc + e - m1 * s.nc + s.N2 * m1;
        if (k < L) po[(long long)k * T] = v;
      });
  if (r == 0 && threadIdx.x == 0) {  // bin L from Z_0, which block 0 holds
    const float2 w0 = w[0];
    po[(long long)L * T] = nyquist_power(cmul(make_float2(w0.x, -w0.y), __ldg(chirp)));
  }
  if constexpr (C > 1) cg::this_cluster().sync();  // no block leaves while its W is read
}

// The cluster launch of C blocks for `smem` bytes: the kernel's shared
// memory raised once per device and size, and how many such clusters the
// card holds at once (cudaOccupancyMaxActiveClusters), asked once per device
// and size.
template <int C>
struct ClusterLaunch {
  static cudaLaunchConfig_t config(long long frames, int smem, cudaStream_t s,
                                   cudaLaunchAttribute* attr) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(frames * C));
    cfg.blockDim = dim3(kClusterThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = C;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
  }

  static cudaError_t max_active(int smem, int& active) {
    static int dev_set = -1, smem_set = 0, dev_asked = -1, smem_asked = -1, asked = 0;
    const void* kernel = (const void*)spectrogram_power_cluster<C>;
    cudaError_t err = raise_smem_to(kernel, smem, dev_set, smem_set);
    if (err != cudaSuccess) return err;
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev != dev_asked || smem != smem_asked) {
      cudaLaunchAttribute attr;
      const cudaLaunchConfig_t cfg = config(1, smem, nullptr, &attr);
      err = cudaOccupancyMaxActiveClusters(&asked, kernel, &cfg);
      if (err != cudaSuccess) return err;
      dev_asked = dev;
      smem_asked = smem;
    }
    active = asked;
    return cudaSuccess;
  }

  static cudaError_t run(const Source& src, const float2* chirp, const float2* bt,
                         const float2* ctab, const float2* twiddle, float* out, int T, int F,
                         bool even, const ClusterSplit& s, long long frames, cudaStream_t stream) {
    const int smem = (int)cluster_smem(s);
    int active = 0;
    cudaError_t err = max_active(smem, active);
    if (err != cudaSuccess) return err;
    if (active < 1) return cudaErrorInvalidClusterSize;  // the card cannot schedule the plan
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = config(frames, smem, stream, &attr);
    err = cudaLaunchKernelEx(&cfg, spectrogram_power_cluster<C>, src, chirp, bt, ctab, twiddle,
                             out, T, F, (int)even, s, mixed_plan_of(s.N1), mixed_plan_of(s.N2));
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  }
};

template <class Fn>
cudaError_t by_cluster(int C, Fn f) {
  switch (C) {
    case 1: return f(ClusterLaunch<1>{});
    case 2: return f(ClusterLaunch<2>{});
    case 4: return f(ClusterLaunch<4>{});
    case 8: return f(ClusterLaunch<8>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The cluster route: an n_fft >= 1 and hop >= 1 whose complex length L
// (n_fft / 2 or n_fft) takes the chirp-z transform over M points, M
// 7-smooth from L + K - 1 on (K = L bins for an even n_fft, n_fft / 2 + 1
// for an odd one), over a cluster of C blocks with the split of N1
// (cluster_split_of, ops/spectrogram.py::cluster_plan) in smem_bytes of
// shared memory a block; chirp, bt, ctab: the chirp-z tables of M
// (ops/spectrogram.py::chirpz_tables); the rest as for the FFT route.  A plan
// the card cannot schedule is refused before the launch.  One launch.
extern "C" int apt_spectrogram_power_cluster(const float* x, const float* window,
                                             const float* twiddle, const float* chirp,
                                             const float* bt, const float* ctab, float* out,
                                             int B, int N, int T, int n_fft, int hop, int pad,
                                             int C, int M, int N1, int smem_bytes, void* stream) {
  const bool even = n_fft % 2 == 0;
  const int L = even ? n_fft / 2 : n_fft, K = even ? L : n_fft / 2 + 1;
  if (n_fft < 1 || hop < 1 || B <= 0 || T <= 0 || N < 0 || pad < 0 || chirp == nullptr ||
      bt == nullptr || ctab == nullptr)
    return (int)cudaErrorInvalidValue;
  const ClusterSplit s = cluster_split_of(M, C);
  if (!s.ok || s.N1 != N1 || cluster_smem(s) != smem_bytes || !seven_smooth(M) ||
      (long long)M < ((long long)L + K - 1 > 2 ? (long long)L + K - 1 : 2))
    return (int)cudaErrorInvalidValue;
  const long long frames = (long long)B * T;
  if (frames * C > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const Source src{even ? Source::kEvenFrame : Source::kOddFrame, x, N, 0, T, hop, pad, window,
                   nullptr, 0, nullptr, L};
  auto f2 = [](const float* p) { return reinterpret_cast<const float2*>(p); };
  return (int)by_cluster(C, [&](auto launch) {
    return decltype(launch)::run(src, f2(chirp), f2(bt), f2(ctab), f2(twiddle), out, T,
                                 n_fft / 2 + 1, even, s, frames, (cudaStream_t)stream);
  });
}

// How many clusters of C blocks of smem_bytes each the current card holds at
// once (cudaOccupancyMaxActiveClusters), into *active.
extern "C" int apt_cluster_max_active(int C, int smem_bytes, int* active) {
  if (active == nullptr || smem_bytes < 0 || smem_bytes > kBlockSmemLimit)
    return (int)cudaErrorInvalidValue;
  return (int)by_cluster(C, [&](auto launch) {
    return decltype(launch)::max_active(smem_bytes, *active);
  });
}
