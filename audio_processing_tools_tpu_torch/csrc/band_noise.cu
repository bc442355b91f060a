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
// 1 us at 3.35 TB/s.  The bound is the chain: a frame waits for the ring
// buffer and the hold the frame before left, so 218 frames take 218 times
// the carried work whatever the card's width.
//
// Design: one warp per lane (clip or stream), one lane per block, the
// kernel instantiated per subframe count.  The frames go in tiles of 32,
// and each tile in three parts, so that only what the carry decides is
// walked frame after frame:
//   1. prologue, one frame per thread: the FFT decision (the frame before
//      by a shuffle), the subframes' levels and trigger bits (the subframe
//      before likewise), the mask and hold of the frame's triggers from no
//      hold (a hold h entering the frame adds subframes s < h and leaves
//      max(h - S, 0) or the triggers' hold, whichever is larger), the push
//      and replenish values and their order among themselves;
//   2. chain, the warp on one frame after another: the hold, the TTL
//      expiry, the pushes, adaptive q and the buffer's quantile, each
//      frame's results kept by the thread of that frame; the next frame's
//      prologue values are shuffled in while this one is walked;
//   3. epilogue: the EMA, the N_E smoothing and the energy sums in frame
//      order (a shuffle a frame, left to right), the integer telemetry as
//      prefix counts, sums and minima over the tile's flags, then one frame
//      per thread the Wiener gain and coalesced stores of every output plane.
// The ring buffer stays slot-ordered in registers (value and frame index,
// thread j holding slots j and j + 32; the valid slots as a warp-uniform
// bit mask), and beside it its valid values in ascending order across the
// threads, each with its slot.  A frame's pushes (its noise subframes, or
// the replenish value) go in together: the overwritten slots' old entries go
// out, every surviving entry moves down by the entries gone before it and up
// by the new values below it, each new value lands after the survivors not
// above it and the new values before it, and one scatter through shared
// memory puts the view together; an expiry compacts the survivors the same
// way; the two order statistics are two shuffles.  Equal values are
// indistinguishable, so the value at a rank is the rank count's (the plain
// loop's masked_quantile_rankselect, invalid slots above every value).  That
// holds while every valid value is ordered: while one is NaN, an infinity or
// a zero (whose sign a tie would pick), the frame takes the rank count over
// the slot-ordered ring instead, and the sorted view is rebuilt once the
// ring is ordered again.  A frame decides first whether it is the common
// one (no expiry, no such value, the ranks inside the view), which then
// runs without a branch to the rare paths.  The next tile's inputs are
// loaded while this one is walked.
//
// Any other ring and subframe count (S > 8, W > 64 or W < S) takes a second
// kernel, band_scan_general: one block of kGenThreads a lane, the ring in
// the lane's carry-out arrays in device memory (value, valid byte, frame
// index), the frame's scalar chain (the FFT decision, the subframe steps,
// the replenish, the adaptive q, the EMA, the telemetry and the gain) on
// thread 0, and the ring's work spread over the block's threads, slot by
// slot: the expiry, the frame's pushes as the JAX program's one-hot
// push_many (band_noise.py:402-429: with W < S the colliding values are
// summed into their slot, left to right, and count_valid grows by every
// push that found its slot invalid before the frame, so it may pass W),
// and the rank count of the buffer's quantile.  It is the plain loop's
// step in its order, so it gives its bits too.
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
#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kMaxS = 8;  // subframes per frame
constexpr unsigned kFull = 0xffffffffu;
constexpr bool kSortedView = true;  // false: the rank count on every frame
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
// a value the sorted view does not hold: NaN, an infinity, or a zero whose
// sign a tie could pick
__device__ __forceinline__ bool unordered(float v) { return !(fabsf(v) <= FLT_MAX) || v == 0.f; }

// one frame's inputs, a thread's
template <int S>
struct FrameIn {
  float sE[S], sEh[S], rs, pr, Eb, Mb;
};

template <int S>
__device__ __forceinline__ void load_frame(const BandIO& io, const BandConsts& c, int b, int t,
                                           FrameIn<S>& f) {
  if (t >= c.T) return;
  const long long ft = (long long)b * c.T + t;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    f.sE[s] = io.subE[ft * S + s];
    f.sEh[s] = io.subEhpf[ft * S + s];
  }
  f.rs = io.rain_sum[ft];
  f.pr = io.primary[ft];
  f.Eb = io.Eb[ft];
  f.Mb = io.Mb[ft];
}

// warp-uniform masks of ring slots: 32 bits for up to 32 slots, else 64
template <int SPL>
using MaskT = typename std::conditional<SPL == 1, unsigned, unsigned long long>::type;
__device__ __forceinline__ int popc(unsigned x) { return __popc(x); }
__device__ __forceinline__ int popc(unsigned long long x) { return __popcll(x); }

// shared memory at 32-bit addresses; a store happens only where `on`, by
// predication
__device__ __forceinline__ void st_shared(uint32_t a, float v, bool on) {
  asm volatile("{\n .reg .pred p;\n setp.ne.u32 p, %2, 0;\n @p st.shared.f32 [%0], %1;\n}\n" ::"r"(a),
               "f"(v), "r"((unsigned)on)
               : "memory");
}
__device__ __forceinline__ void st_shared(uint32_t a, int v, bool on) {
  asm volatile("{\n .reg .pred p;\n setp.ne.u32 p, %2, 0;\n @p st.shared.s32 [%0], %1;\n}\n" ::"r"(a),
               "r"(v), "r"((unsigned)on)
               : "memory");
}
__device__ __forceinline__ float ld_shared_f32(uint32_t a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(a) : "memory");
  return v;
}
__device__ __forceinline__ int ld_shared_s32(uint32_t a) {
  int v;
  asm volatile("ld.shared.s32 %0, [%1];\n" : "=r"(v) : "r"(a) : "memory");
  return v;
}

// The ring buffer of one stream, SPL slots and sorted positions a thread:
// slot (position) k * 32 + lane.
template <int SPL>
struct Ring {
  using Mask = MaskT<SPL>;
  static constexpr int kBits = 8 * (int)sizeof(Mask);
  float bv[SPL];  // slot-ordered values
  int bi[SPL];    // slot-ordered frame indices
  float sk[SPL];  // the valid values in ascending order, FLT_MAX past them
  int ss[SPL];    // the slot of each
  Mask vmask = 0, badmask = 0;  // valid slots; slots (valid or not) holding unordered values
  bool sorted_ok = false;       // sk/ss describe the ring
  uint32_t key_at, slot_at;     // shared arrays the sorted view is put together in

  __device__ __forceinline__ static int pos(int k) { return k * 32 + (int)threadIdx.x; }
  __device__ __forceinline__ static Mask below(int p) { return (Mask(1) << p) - Mask(1); }
  __device__ __forceinline__ bool valid(int k) const { return (vmask >> pos(k)) & 1u; }
  // the slots w .. w + m - 1 around a ring of W (m <= W)
  __device__ __forceinline__ static Mask range(int w, int m, int W) {
    const Mask all = W == kBits ? ~Mask(0) : below(W);
    Mask r = (below(m) << w) & all;
    if (w + m > W) r |= below(w + m - W);
    return r;
  }
  // the value at warp-uniform position `p`
  template <typename V>
  __device__ __forceinline__ static V at(const V (&a)[SPL], int p) {
    V v = a[0];
#pragma unroll
    for (int k = 0; k < SPL; ++k)
      if (k == (p >> 5)) v = a[k];
    return __shfl_sync(kFull, v, p & 31);
  }
  template <typename P>
  __device__ __forceinline__ static Mask ballot(P pred) {
    Mask m = 0;
#pragma unroll
    for (int k = 0; k < SPL; ++k) m |= (Mask)__ballot_sync(kFull, pred(k)) << (32 * k);
    return m;
  }

  // entry (v, w) of the sorted view at position d, where `on`
  __device__ __forceinline__ void put(int d, float v, int w, bool on) const {
    st_shared(key_at + 4 * d, v, on);
    st_shared(slot_at + 4 * d, w, on);
  }
  // the sorted view from what `put` wrote
  __device__ __forceinline__ void read_back() {
    __syncwarp();
#pragma unroll
    for (int k = 0; k < SPL; ++k) {
      sk[k] = ld_shared_f32(key_at + 4 * pos(k));
      ss[k] = ld_shared_s32(slot_at + 4 * pos(k));
    }
    __syncwarp();
  }

  // the sorted view of the slot ring: each valid value's rank among the
  // valid values (ties by slot), then a scatter through shared memory
  __device__ __forceinline__ void rebuild(int W) {
    int rank[SPL];
#pragma unroll
    for (int k = 0; k < SPL; ++k) rank[k] = 0;
    for (int src = 0; src < W; ++src) {
      if (!((vmask >> src) & 1u)) continue;  // uniform
      const float xs = at(bv, src);
#pragma unroll
      for (int k = 0; k < SPL; ++k)
        rank[k] += (xs < bv[k] || (xs == bv[k] && src < pos(k))) ? 1 : 0;
    }
    const int n = popc(vmask);
#pragma unroll
    for (int k = 0; k < SPL; ++k) {
      put(rank[k], bv[k], pos(k), valid(k));
      put(pos(k), FLT_MAX, -1, pos(k) >= n);
    }
    read_back();
    sorted_ok = true;
  }

  // the sorted view without the entries of the slots in `gone`
  __device__ __forceinline__ void compact(Mask gone) {
    const int n = popc(vmask);
    bool keep[SPL];
#pragma unroll
    for (int k = 0; k < SPL; ++k) keep[k] = pos(k) < n && !((gone >> (ss[k] & (kBits - 1))) & 1u);
    const Mask kept = ballot([&](int k) { return keep[k]; });
    const int n_kept = popc(kept);
#pragma unroll
    for (int k = 0; k < SPL; ++k) {
      put(popc(kept & below(pos(k))), sk[k], ss[k], keep[k]);
      put(pos(k), FLT_MAX, -1, pos(k) >= n_kept);
    }
    read_back();
  }

  // one frame's pushes: candidate s of u (the frame's noise subframes, then
  // the replenish value) goes in when bit s of `pm` is set, into slot
  // wr + (the set bits below s), in order, as band_noise.py::push does them
  // one after another (the slots are distinct while S <= W).  The slot ring
  // takes each value.  With kKeep (the caller knows the sorted view
  // describes the ring and no new value is unordered) or where that holds,
  // the sorted view loses the overwritten slots' entries and takes the new
  // values in one merge: old entries before new values of the same value,
  // new values among themselves in the order `before` gives (10 bits a
  // candidate, three to a word: the candidates ahead of it).
  template <bool kKeep, int NC, int NW>
  __device__ __forceinline__ void push(const float (&u)[NC], const unsigned (&before)[NW],
                                       unsigned pm, unsigned bad, int& wr, int W, int frame,
                                       int& count_valid) {
    const int lane = threadIdx.x;
    const int m = __popc(pm), wr0 = wr;
    auto gap = [&](int w) {  // slots from wr0 to w, around the ring
      const int d = w - wr0;
      return d < 0 ? d + W : d;
    };
    int order[NC];  // push order of each candidate
#pragma unroll
    for (int s = 0; s < NC; ++s) order[s] = __popc(pm & ((1u << s) - 1u));
    const Mask rm = range(wr0, m, W);
    bool vbad[SPL];
#pragma unroll
    for (int k = 0; k < SPL; ++k) {
      const int d = gap(pos(k));
      const bool in = (rm >> pos(k)) & 1u;
      float v = 0.f;
      bool b = false;
#pragma unroll
      for (int s = 0; s < NC; ++s) {
        const bool hit = ((pm >> s) & 1u) && order[s] == d;
        v = hit ? u[s] : v;
        b = hit ? ((bad >> s) & 1u) != 0 : b;
      }
      vbad[k] = in && b;
      bv[k] = in ? v : bv[k];
      bi[k] = in ? frame : bi[k];
    }
    const Mask rbad = kKeep ? Mask(0) : ballot([&](int k) { return vbad[k]; });
    const Mask old_valid = vmask;
    count_valid += popc(rm & ~old_valid);
    vmask |= rm;
    badmask = (badmask & ~rm) | rbad;
    wr = wr0 + m >= W ? wr0 + m - W : wr0 + m;
    if (!kKeep) {
      if (!sorted_ok) return;
      if (rbad) {
        sorted_ok = false;
        return;
      }
    }
    // the merge
    const int n = popc(old_valid);
    bool surv[SPL];
#pragma unroll
    for (int k = 0; k < SPL; ++k) surv[k] = pos(k) < n && gap(ss[k] & (kBits - 1)) >= m;
    const Mask kept = ballot([&](int k) { return surv[k]; });
    const int n_new = popc(kept) + m;
    // a survivor: after the survivors before it and the new values below it
#pragma unroll
    for (int k = 0; k < SPL; ++k) {
      int d = popc(kept & below(pos(k)));
#pragma unroll
      for (int s = 0; s < NC; ++s) d += (((pm >> s) & 1u) && u[s] < sk[k]) ? 1 : 0;
      put(d, sk[k], ss[k], surv[k]);
      put(pos(k), FLT_MAX, -1, pos(k) >= n_new);
    }
    // new value `lane`: after the survivors not above it and the new values
    // before it
    int not_above = 0, my_order = 0;
    float mine = u[0];
    unsigned ahead = 0;
#pragma unroll
    for (int s = 0; s < NC; ++s) {
      const int c = popc(ballot([&](int k) { return surv[k] && sk[k] <= u[s]; }));
      const bool me = lane == s;
      not_above = me ? c : not_above;
      mine = me ? u[s] : mine;
      my_order = me ? order[s] : my_order;
      ahead = me ? (before[s / 3] >> (10 * (s % 3))) & 0x3ffu : ahead;
    }
    const int w = wr0 + my_order;
    put(not_above + __popc(pm & ahead), mine, w >= W ? w - W : w,
        lane < NC && ((pm >> lane) & 1u));
    read_back();
  }

  // the rank count of the plain loop (masked_quantile_rankselect) over the
  // slot ring: the values at ranks lo and hi, the first slot holding each
  // rank, slot 0's where no slot does
  __device__ __forceinline__ void rank_count(int W, int lo, int hi, float& v_lo,
                                             float& v_hi) const {
    float xv[SPL];
    int rank[SPL];
#pragma unroll
    for (int k = 0; k < SPL; ++k) {
      xv[k] = valid(k) ? bv[k] : FLT_MAX;
      rank[k] = 0;
    }
    for (int src = 0; src < W; ++src) {
      const float xs = at(xv, src);
#pragma unroll
      for (int k = 0; k < SPL; ++k)
        rank[k] += (xs < xv[k] || (xs == xv[k] && src < pos(k))) ? 1 : 0;
    }
    v_lo = v_hi = __shfl_sync(kFull, xv[0], 0);
#pragma unroll
    for (int k = SPL - 1; k >= 0; --k) {
      const bool real = pos(k) < W;
      const unsigned at_lo = __ballot_sync(kFull, real && rank[k] == lo);
      const unsigned at_hi = __ballot_sync(kFull, real && rank[k] == hi);
      const float from_lo = __shfl_sync(kFull, xv[k], at_lo ? __ffs(at_lo) - 1 : 0);
      const float from_hi = __shfl_sync(kFull, xv[k], at_hi ? __ffs(at_hi) - 1 : 0);
      if (at_lo) v_lo = from_lo;
      if (at_hi) v_hi = from_hi;
    }
  }
};

template <int SPL, int S>
__global__ void __launch_bounds__(32)
band_scan(const BandIO io, const BandConsts c) {
  __shared__ float sh_key[32 * SPL];
  __shared__ int sh_slot[32 * SPL];
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  const int T = c.T, W = c.W;
  constexpr unsigned all = (1u << S) - 1u;
  const long long plane = (long long)c.B * T;

  const float* cf = io.cf + (long long)b * kCF;
  const int* ci = io.ci + (long long)b * kCI;
  float prev_rain = cf[0], prev_prim = cf[1], prev_Eb = cf[2], prev_Lb = cf[3], prev_Lh = cf[4],
        ema = cf[5], q_eff = cf[6], ne_smooth = cf[7], e_noise = cf[8], e_rain = cf[9],
        e_total = cf[10];
  bool have_fft = ci[0] != 0, have_Eb = ci[1] != 0, have_L = ci[2] != 0;
  int hold = ci[3], wr = ci[4], count_valid = ci[5], fsnu = ci[6], frame_idx = ci[7],
      n_noise = ci[8], n_rain = ci[9], n_total = ci[10], min_valid = ci[11], underflow = ci[12],
      learned_total = ci[13], replenish_total = ci[14];

  Ring<SPL> ring;
#pragma unroll
  for (int k = 0; k < SPL; ++k) {
    const int w = k * 32 + lane;
    const long long g = (long long)b * W + w;
    ring.bv[k] = w < W ? io.buf[g] : 0.f;
    ring.bi[k] = w < W ? io.bidx[g] : -1;
  }
  ring.vmask = Ring<SPL>::ballot(
      [&](int k) { return k * 32 + lane < W && io.valid[(long long)b * W + k * 32 + lane] != 0; });
  ring.badmask =
      Ring<SPL>::ballot([&](int k) { return k * 32 + lane < W && unordered(ring.bv[k]); });
  ring.key_at = (uint32_t)__cvta_generic_to_shared(sh_key);
  ring.slot_at = (uint32_t)__cvta_generic_to_shared(sh_slot);
  using Mask = typename Ring<SPL>::Mask;

  FrameIn<S> in = {}, nxt = {};
  load_frame(io, c, b, lane, in);
  for (int t0 = 0; t0 < T; t0 += 32) {
    const int nf = min(32, T - t0);
    const bool act = lane < nf;
    const int t = t0 + lane;

    // ==== 1. prologue: this thread's frame, from its inputs alone ====
    // FFT rain decision against the frame before
    float rs_prev = __shfl_up_sync(kFull, in.rs, 1), pr_prev = __shfl_up_sync(kFull, in.pr, 1);
    bool have_prev = true;
    if (lane == 0) {
      rs_prev = prev_rain;
      pr_prev = prev_prim;
      have_prev = have_fft;
    }
    const bool fft_rain = have_prev && in.rs > __fmul_rn(__fadd_rn(rs_prev, c.eps12), c.M_ratio) &&
                          in.pr > __fmul_rn(__fadd_rn(pr_prev, c.eps12), c.N_ratio);
    // the subframes' levels
    float Ebs[S], Lb[S], Lh[S];
    unsigned ok = 0;
    float ok_Lb = 0.f, ok_Lh = 0.f;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      Ebs[s] = max_nan(in.sE[s], c.eps12);
      const bool o = in.sEh[s] >= c.min_Ehpf && Ebs[s] >= c.min_Eband;
      Lb[s] = __fmul_rn(10.f, log10f(__fadd_rn(Ebs[s], c.eps12)));
      Lh[s] = __fmul_rn(10.f, log10f(__fadd_rn(in.sEh[s], c.eps12)));
      ok |= (unsigned)o << s;
      if (o) {
        ok_Lb = Lb[s];
        ok_Lh = Lh[s];
      }
    }
    const bool last_ok = (ok >> (S - 1)) & 1u;
    // the subframe before each: the frame before's last, or the carry
    float p_Eb = __shfl_up_sync(kFull, Ebs[S - 1], 1), p_Lb = __shfl_up_sync(kFull, Lb[S - 1], 1),
          p_Lh = __shfl_up_sync(kFull, Lh[S - 1], 1);
    bool p_ok = __shfl_up_sync(kFull, last_ok, 1), p_have_Eb = true;
    if (lane == 0) {
      p_Eb = prev_Eb;
      p_Lb = prev_Lb;
      p_Lh = prev_Lh;
      p_ok = have_L;
      p_have_Eb = have_Eb;
    }
    // trigger bits, and the mask and hold they make from no hold
    unsigned mask0 = 0;
    int g_hold = INT_MIN;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const bool o = (ok >> s) & 1u;
      const float dLb = __fsub_rn(Lb[s], p_Lb);
      const float dLh = __fsub_rn(Lh[s], p_Lh);
      bool trig = o && p_ok && dLb >= c.band_rise_db && __fsub_rn(dLb, dLh) >= c.excess_rise_db;
      if (c.use_dE) {
        const float dE = max_nan(__fsub_rn(Ebs[s], p_Eb), 0.f);
        const float metric = __fdiv_rn(dE, __fadd_rn(max_nan(in.sEh[s], c.eps12), c.eps12));
        trig = trig || (p_have_Eb && metric >= c.dE_thr);
      }
      if (c.use_D)
        trig = trig || (p_have_Eb && Ebs[s] > __fmul_rn(__fadd_rn(p_Eb, c.eps12), c.D_ratio));
      if (g_hold > 0 || trig) mask0 |= 1u << s;
      if (g_hold > 0) g_hold -= 1;
      if (trig) g_hold = max(g_hold, c.hold_k);
      p_Eb = Ebs[s];
      p_Lb = Lb[s];
      p_Lh = Lh[s];
      p_ok = o;
      p_have_Eb = true;
    }
    // the push values (candidates 0 .. S - 1) and the replenish value (S)
    float pv[S + 1];
    unsigned pbad = 0;
#pragma unroll
    for (int s = 0; s < S; ++s) pv[s] = max_nan(in.sE[s], c.eps);
    pv[S] = 0.f;
    if (c.replenish) {
      // quantile_linear over the S energies: an insertion sort, then
      // interpolated
      float srt[S];
#pragma unroll
      for (int s = 0; s < S; ++s) srt[s] = in.sE[s];
#pragma unroll
      for (int i = 1; i < S; ++i) {
        const float v = srt[i];
        bool moving = true;
#pragma unroll
        for (int j = i - 1; j >= 0; --j) {
          if (moving && srt[j] > v) {
            srt[j + 1] = srt[j];
          } else if (moving) {
            srt[j + 1] = v;
            moving = false;
          }
        }
        if (moving) srt[0] = v;
      }
      float v_lo = srt[0], v_hi = srt[0];
#pragma unroll
      for (int s = 1; s < S; ++s) {
        if (s == c.rq_lo) v_lo = srt[s];
        if (s == c.rq_hi) v_hi = srt[s];
      }
      pv[S] = max_nan(lerp_rn(v_lo, v_hi, c.rq_frac), c.eps);
    }
#pragma unroll
    for (int s = 0; s <= S; ++s) pbad |= (unsigned)unordered(pv[s]) << s;
    // for each candidate, the candidates ahead of it among equal values' index
    // order, for the merge of the frame's pushes
    constexpr int NW = (S + 3) / 3;
    unsigned before[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) before[w] = 0;
#pragma unroll
    for (int s = 0; s <= S; ++s) {
      unsigned ahead = 0;
#pragma unroll
      for (int q = 0; q <= S; ++q)
        ahead |= (unsigned)(pv[q] < pv[s] || (pv[q] == pv[s] && q < s)) << q;
      before[s / 3] |= ahead << (10 * (s % 3));
    }
    const unsigned packed = mask0 | pbad << 16;
    const unsigned fft_bits = __ballot_sync(kFull, act && fft_rain);

    // what the next tile's first frame takes as the frame before
    const int last = nf - 1;
    prev_rain = __shfl_sync(kFull, in.rs, last);
    prev_prim = __shfl_sync(kFull, in.pr, last);
    prev_Eb = __shfl_sync(kFull, Ebs[S - 1], last);
    have_L = __shfl_sync(kFull, last_ok, last);
    have_fft = have_Eb = true;
    const unsigned any_ok = __ballot_sync(kFull, act && ok != 0);
    if (any_ok) {
      const int src = 31 - __clz(any_ok);
      prev_Lb = __shfl_sync(kFull, ok_Lb, src);
      prev_Lh = __shfl_sync(kFull, ok_Lh, src);
    }

    // the next tile's inputs, loaded while this one is walked
    load_frame(io, c, b, t + 32, nxt);

    // ==== 2. chain: the warp walks the frames for what the carry decides ====
    float r_qv = 0.f, r_q = 0.f;
    unsigned r_sub = 0;
    int r_cv = 0, r_learned = 0, r_rep = 0;
    // frame i's prologue values, shuffled in a frame ahead
    unsigned f_packed = __shfl_sync(kFull, packed, 0);
    int f_g = __shfl_sync(kFull, g_hold, 0);
    float f_pv[S + 1];
    unsigned f_before[NW];
#pragma unroll
    for (int s = 0; s <= S; ++s) f_pv[s] = __shfl_sync(kFull, pv[s], 0);
#pragma unroll
    for (int w = 0; w < NW; ++w) f_before[w] = __shfl_sync(kFull, before[w], 0);
    for (int i = 0; i < nf; ++i) {
      const unsigned pk = f_packed;
      const int gS = f_g;
      float u[S + 1];
      unsigned ub[NW];
#pragma unroll
      for (int s = 0; s <= S; ++s) u[s] = f_pv[s];
#pragma unroll
      for (int w = 0; w < NW; ++w) ub[w] = f_before[w];
      const int i1 = (i + 1) & 31;
      f_packed = __shfl_sync(kFull, packed, i1);
      f_g = __shfl_sync(kFull, g_hold, i1);
#pragma unroll
      for (int s = 0; s <= S; ++s) f_pv[s] = __shfl_sync(kFull, pv[s], i1);
#pragma unroll
      for (int w = 0; w < NW; ++w) f_before[w] = __shfl_sync(kFull, before[w], i1);

      frame_idx += 1;
      // ---- the hold over the subframes ----
      const unsigned mask = (pk & 0xffu) | (hold > 0 ? (1u << min(hold, S)) - 1u : 0u);
      hold = max(hold > 0 ? max(hold - S, 0) : hold, gS);
      const unsigned sub = (fft_bits >> i) & 1u ? all : mask;

      // ---- what the frame does, decided before anything changes ----
      // expiry before learning
      Mask stale = 0;
      if (c.ttl > 0)
        stale = Ring<SPL>::ballot(
            [&](int k) { return ring.valid(k) && frame_idx - ring.bi[k] > c.ttl; });
      const bool expire = count_valid > 0 && stale != 0;
      const int cv = expire ? max(count_valid - popc(stale), 0) : count_valid;
      // learning: the noise subframes, or else the replenish value
      const unsigned learn = c.learn_all ? all : (~sub & all);
      const int learned = __popc(learn);
      unsigned pm = learn;
      int replenish = 0;
      if (c.replenish && learned == 0 && (!c.replenish_not_full || cv < W)) {
        pm = 1u << S;
        replenish = 1;
      }
      // adaptive q
      float q = q_eff;
      if (c.q_adapt) {
        if (replenish > 0) q = __fadd_rn(__fmul_rn(q, c.ra_keep), c.ra_add);
        if (learned > 0) q = __fadd_rn(__fmul_rn(q, c.na_keep), c.na_add);
        q = clamp_nan(q, c.q_min, c.q_max);
      }
      q_eff = q;
      // the quantile's ranks in the buffer the frame leaves
      const int count = popc((expire ? ring.vmask & ~stale : ring.vmask) |
                             Ring<SPL>::range(wr, __popc(pm), W));
      const float h = __fmul_rn(q_eff, (float)max(count - 1, 0));
      const int lo = (int)floorf(h), hi = (int)ceilf(h);
      const float frac = __fsub_rn(h, (float)lo);
      const bool in_view = lo >= 0 && hi < W;

      float v_lo, v_hi;
      if (kSortedView && !expire && ring.sorted_ok && (pm & (pk >> 16)) == 0 &&
          (ring.vmask & ring.badmask) == 0 && in_view) {
        // the common frame: the pushes merge into the sorted view, which
        // holds the two order statistics
        if (pm) ring.template push<true>(u, ub, pm, pk >> 16, wr, W, frame_idx, count_valid);
        v_lo = Ring<SPL>::at(ring.sk, lo);
        v_hi = Ring<SPL>::at(ring.sk, hi);
      } else {
        if (expire) {
          if (ring.sorted_ok) ring.compact(stale);
#pragma unroll
          for (int k = 0; k < SPL; ++k)
            if ((stale >> (k * 32 + lane)) & 1u) {
              ring.bv[k] = 0.f;
              ring.bi[k] = -1;
            }
          ring.vmask &= ~stale;
          count_valid = cv;
        }
        if (pm) ring.template push<false>(u, ub, pm, pk >> 16, wr, W, frame_idx, count_valid);
        if (kSortedView && (ring.vmask & ring.badmask) == 0 && in_view) {
          if (!ring.sorted_ok) ring.rebuild(W);
          v_lo = Ring<SPL>::at(ring.sk, lo);
          v_hi = Ring<SPL>::at(ring.sk, hi);
        } else {
          ring.rank_count(W, lo, hi, v_lo, v_hi);
        }
      }
      const float qv = count > 0 ? lerp_rn(v_lo, v_hi, frac) : 0.f;

      // frame i's results stay with thread i
      const bool here = lane == i;
      r_qv = here ? qv : r_qv;
      r_q = here ? q_eff : r_q;
      r_sub = here ? sub : r_sub;
      r_cv = here ? count_valid : r_cv;
      r_learned = here ? learned : r_learned;
      r_rep = here ? replenish : r_rep;
    }

    // ==== 3. epilogue: this thread's frame again ====
    float rain_e = (r_sub & 1u) ? in.sE[0] : 0.f;
    float dry_e = (r_sub & 1u) ? 0.f : in.sE[0];
#pragma unroll
    for (int s = 1; s < S; ++s) {
      const bool r = (r_sub >> s) & 1u;
      rain_e = __fadd_rn(rain_e, r ? in.sE[s] : 0.f);
      dry_e = __fadd_rn(dry_e, r ? 0.f : in.sE[s]);
    }
    const float tot_e = max_nan(in.Eb, 0.f);
    const unsigned warm_bits = __ballot_sync(kFull, act && r_cv >= c.W_min);
    const unsigned rain_bits = __ballot_sync(kFull, act && r_sub != 0);
    // the noise scalar (warm-up semantics), its smoothing and the energy
    // sums, frame after frame
    float o_ne = 0.f, o_ne_raw = 0.f, o_nsub = 0.f, o_noise = 0.f, o_rain = 0.f, o_total = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (i >= nf) break;
      const float qv = __shfl_sync(kFull, r_qv, i), a = __shfl_sync(kFull, tot_e, i),
                  r = __shfl_sync(kFull, rain_e, i), dry = __shfl_sync(kFull, dry_e, i);
      const bool warm = (warm_bits >> i) & 1u, any_rain = (rain_bits >> i) & 1u;
      const float ema_new = __fadd_rn(__fmul_rn(c.ema_keep, ema), __fmul_rn(c.ema_a, qv));
      ema = warm ? ema_new : 0.f;
      if (!warm) ne_smooth = 0.f;
      const float n_sub = warm ? ema : 0.f;
      const float ne_raw = __fmul_rn(c.S_f, n_sub);
      float ne = ne_raw;
      if (c.smooth) {
        const float up = any_rain ? c.wet : c.dry;
        const float alpha = ne_raw > ne_smooth ? up : c.release;
        ne_smooth =
            __fadd_rn(__fmul_rn(__fsub_rn(1.f, alpha), ne_smooth), __fmul_rn(alpha, ne_raw));
        ne = ne_smooth;
      }
      e_total = __fadd_rn(e_total, a);
      e_rain = __fadd_rn(e_rain, r);
      e_noise = __fadd_rn(e_noise, min_nan(max_nan(ne, 0.f), max_nan(dry, 0.f)));
      const bool here = lane == i;
      o_ne = here ? ne : o_ne;
      o_ne_raw = here ? ne_raw : o_ne_raw;
      o_nsub = here ? n_sub : o_nsub;
      o_total = here ? e_total : o_total;
      o_rain = here ? e_rain : o_rain;
      o_noise = here ? e_noise : o_noise;
    }
    // the counters at each frame, from the tile's flags: prefix counts,
    // sums and minima over the frames up to this thread's
    const unsigned upto = (2u << lane) - 1u;
    const unsigned under_bits = __ballot_sync(kFull, act && r_cv < c.W_min);
    const unsigned rep_bits = __ballot_sync(kFull, act && r_rep != 0);
    const unsigned upd_bits = __ballot_sync(kFull, act && r_learned + r_rep > 0);
    const int o_nt = n_total + lane + 1;
    const int o_nr = n_rain + __popc(rain_bits & upto);
    const int o_nn = n_noise + lane + 1 - __popc(rain_bits & upto);
    const int o_under = underflow + __popc(under_bits & upto);
    const int o_rt = replenish_total + __popc(rep_bits & upto);
    const unsigned upd_upto = upd_bits & upto;
    const int o_fsnu = upd_upto ? lane - (31 - __clz(upd_upto)) : fsnu + lane + 1;
    int o_lt = act ? r_learned : 0;
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const int v = __shfl_up_sync(kFull, o_lt, d);
      if (lane >= d) o_lt += v;
    }
    o_lt += learned_total;
    // min_valid: the carried minimum and the frames' counts, but from the
    // count alone at the frame whose total before it is 0 (a fresh stream's
    // first frame)
    const int restart = n_total <= 0 && -n_total < nf ? -n_total : 32;
    auto prefix_min = [&](bool from) {  // over the frames >= restart (from) or below it
      int v = act && (lane >= restart) == from ? r_cv : INT_MAX;
#pragma unroll
      for (int d = 1; d < 32; d *= 2) {
        const int o = __shfl_up_sync(kFull, v, d);
        if (lane >= d) v = min(v, o);
      }
      return v;
    };
    int o_minv = 0;
    if (restart > 0) o_minv = min(prefix_min(false), min_valid);
    if (restart < 32) {
      const int fresh = prefix_min(true);
      if (lane >= restart) o_minv = fresh;
    }
    // the carried counters after the tile's last frame
    n_total += nf;
    n_rain = __shfl_sync(kFull, o_nr, last);
    n_noise = __shfl_sync(kFull, o_nn, last);
    underflow = __shfl_sync(kFull, o_under, last);
    replenish_total = __shfl_sync(kFull, o_rt, last);
    fsnu = __shfl_sync(kFull, o_fsnu, last);
    learned_total = __shfl_sync(kFull, o_lt, last);
    min_valid = __shfl_sync(kFull, o_minv, last);
    if (act) {
      // ---- Wiener gain ----
      const float num = max_nan(__fsub_rn(in.Eb, __fmul_rn(c.beta, o_ne)), 0.f);
      const float g_pow = __fdiv_rn(num, __fadd_rn(in.Eb, c.eps));
      const float g = clamp_nan(__fsqrt_rn(clamp_nan(g_pow, 0.f, 1.f)), c.gain_floor, 1.f);
      // each plane's 32 frames are contiguous
      const long long o = (long long)b * T + t;
      const float fo[kOF] = {o_ne,    o_ne_raw, g,       __fmul_rn(in.Mb, g), o_nsub,
                             o_noise, o_rain,   o_total, r_q};
      const int io_[kOI] = {fft_rain, o_nn,   o_nr,  o_nt, r_cv, o_minv, o_under, o_fsnu,
                            o_lt,     o_rt};
#pragma unroll
      for (int k = 0; k < kOF; ++k) io.of[k * plane + o] = fo[k];
#pragma unroll
      for (int k = 0; k < kOI; ++k) io.oi[k * plane + o] = io_[k];
#pragma unroll
      for (int s = 0; s < S; ++s) io.om[o * S + s] = (r_sub >> s) & 1u;
    }
    in = nxt;
  }

  // ---- the carry after the last frame ----
#pragma unroll
  for (int k = 0; k < SPL; ++k) {
    const int w = k * 32 + lane;
    if (w < W) {
      const long long g = (long long)b * W + w;
      io.o_buf[g] = ring.bv[k];
      io.o_valid[g] = ring.valid(k);
      io.o_bidx[g] = ring.bi[k];
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

// ---------------------------------------------------------------------------
// Every other geometry: a block a lane, the ring in device memory
// ---------------------------------------------------------------------------

constexpr int kGenThreads = 128;

// shared scalars of the general kernel
enum { kShStale, kShCount, kShLo, kShHi, kShSlotLo, kShSlotHi, kShDo, kShInts };

__global__ void __launch_bounds__(kGenThreads)
band_scan_general(const BandIO io, const BandConsts c) {
  extern __shared__ float gsm[];
  const int S = c.S, W = c.W, T = c.T, b = blockIdx.x, tid = threadIdx.x;
  float* const s_val = gsm;                                  // [S] the frame's push values
  float* const s_srt = s_val + S;                            // [S] the replenish sort
  int* const s_pos = reinterpret_cast<int*>(s_srt + S);      // [S] each push's slot, -1: none
  __shared__ int sh[kShInts];
  __shared__ int sh_frame;
  const long long plane = (long long)c.B * T;
  float* const buf = io.o_buf + (long long)b * W;
  uint8_t* const valid = io.o_valid + (long long)b * W;
  int* const bidx = io.o_bidx + (long long)b * W;
  for (int w = tid; w < W; w += kGenThreads) {
    const long long g = (long long)b * W + w;
    buf[w] = io.buf[g];
    valid[w] = io.valid[g] != 0;
    bidx[w] = io.bidx[g];
  }

  // the carried scalars, thread 0's
  const float* cf = io.cf + (long long)b * kCF;
  const int* ci = io.ci + (long long)b * kCI;
  float prev_rain = cf[0], prev_prim = cf[1], prev_Eb = cf[2], prev_Lb = cf[3], prev_Lh = cf[4],
        ema = cf[5], q_eff = cf[6], ne_smooth = cf[7], e_noise = cf[8], e_rain = cf[9],
        e_total = cf[10];
  bool have_fft = ci[0] != 0, have_Eb = ci[1] != 0, have_L = ci[2] != 0;
  int hold = ci[3], wr = ci[4], count_valid = ci[5], fsnu = ci[6], frame_idx = ci[7],
      n_noise = ci[8], n_rain = ci[9], n_total = ci[10], min_valid = ci[11], underflow = ci[12],
      learned_total = ci[13], replenish_total = ci[14];
  bool fft_rain = false;
  unsigned any_rain = 0;
  int learned = 0;
  float rain_e = 0.f, dry_e = 0.f;
  if (tid == 0) {
    sh[kShStale] = 0;
    sh[kShCount] = 0;
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const long long ft = (long long)b * T + t;
    const float* const sE = io.subE + ft * S;
    if (tid == 0) {
      frame_idx += 1;
      sh_frame = frame_idx;
      // ---- FFT rain decision ----
      const float rs = io.rain_sum[ft], pr = io.primary[ft];
      fft_rain = have_fft && rs > __fmul_rn(__fadd_rn(prev_rain, c.eps12), c.M_ratio) &&
                 pr > __fmul_rn(__fadd_rn(prev_prim, c.eps12), c.N_ratio);
      prev_rain = rs;
      prev_prim = pr;
      have_fft = true;
      // ---- the subframes' mask, the push values and the rain and dry sums ----
      const float* const sEh = io.subEhpf + ft * S;
      any_rain = 0;
      for (int s = 0; s < S; ++s) {
        const float Eb_s = max_nan(sE[s], c.eps12);
        bool m = hold > 0;
        if (m) hold -= 1;
        const float Eh_s = sEh[s];
        const bool ok = Eh_s >= c.min_Ehpf && Eb_s >= c.min_Eband;
        const float Lb = __fmul_rn(10.f, log10f(__fadd_rn(Eb_s, c.eps12)));
        const float Lh = __fmul_rn(10.f, log10f(__fadd_rn(Eh_s, c.eps12)));
        const float dLb = __fsub_rn(Lb, prev_Lb), dLh = __fsub_rn(Lh, prev_Lh);
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
        if (c.use_D) trig = trig || (have_Eb && Eb_s > __fmul_rn(__fadd_rn(prev_Eb, c.eps12), c.D_ratio));
        m = m || trig;
        if (trig) hold = max(hold, c.hold_k);
        prev_Eb = Eb_s;
        have_Eb = true;
        const bool sub = m || fft_rain;
        io.om[ft * S + s] = sub;
        any_rain |= sub;
        const float e = sE[s];
        rain_e = s == 0 ? (sub ? e : 0.f) : __fadd_rn(rain_e, sub ? e : 0.f);
        dry_e = s == 0 ? (sub ? 0.f : e) : __fadd_rn(dry_e, sub ? 0.f : e);
        s_val[s] = max_nan(e, c.eps);
        s_srt[s] = e;
        s_pos[s] = (c.learn_all || !sub) ? 1 : -1;  // the learn flag; the slot comes below
      }
    }
    __syncthreads();
    const int frame = sh_frame;

    // ---- expiry before learning ----
    if (c.ttl > 0) {
      int n = 0;
      for (int w = tid; w < W; w += kGenThreads) n += valid[w] && frame - bidx[w] > c.ttl;
      if (n) atomicAdd(&sh[kShStale], n);
      __syncthreads();
      if (tid == 0) {
        sh[kShDo] = count_valid > 0;
        if (count_valid > 0) count_valid = max(count_valid - sh[kShStale], 0);
        sh[kShStale] = 0;
      }
      __syncthreads();
      if (sh[kShDo]) {
        for (int w = tid; w < W; w += kGenThreads) {
          if (valid[w] && frame - bidx[w] > c.ttl) {
            valid[w] = 0;
            buf[w] = 0.f;
            bidx[w] = -1;
          }
        }
      }
      __syncthreads();
    }

    // ---- learning: the pushes' slots, and the count of pushes that find
    // their slot invalid before the frame ----
    if (tid == 0) {
      int offs = 0, added = 0;
      for (int s = 0; s < S; ++s) {
        if (s_pos[s] < 0) continue;
        int pos = (wr + offs) % W;
        s_pos[s] = pos;
        added += valid[pos] ? 0 : 1;
        ++offs;
      }
      learned = offs;
      count_valid += added;
      wr = (wr + offs) % W;
    }
    __syncthreads();
    // each slot takes the sum of the values pushed into it, left to right
    int n_valid = 0;
    for (int w = tid; w < W; w += kGenThreads) {
      float acc = 0.f;
      bool hit = false;
      for (int s = 0; s < S; ++s) {
        const bool h = s_pos[s] == w;
        acc = __fadd_rn(acc, h ? s_val[s] : 0.f);
        hit = hit || h;
      }
      if (hit) {
        buf[w] = acc;
        valid[w] = 1;
        bidx[w] = frame;
      }
      n_valid += valid[w];
    }
    if (n_valid) atomicAdd(&sh[kShCount], n_valid);
    __syncthreads();

    if (tid == 0) {
      int count = sh[kShCount];
      sh[kShCount] = 0;
      // ---- the replenish push ----
      int replenish = 0;
      if (c.replenish && learned == 0 && (!c.replenish_not_full || count_valid < W)) {
        // quantile_linear over the S energies: an insertion sort, interpolated
        for (int i = 1; i < S; ++i) {
          const float v = s_srt[i];
          int j = i - 1;
          while (j >= 0 && s_srt[j] > v) {
            s_srt[j + 1] = s_srt[j];
            --j;
          }
          s_srt[j + 1] = v;
        }
        const float v = max_nan(lerp_rn(s_srt[c.rq_lo], s_srt[c.rq_hi], c.rq_frac), c.eps);
        const bool was_valid = valid[wr] != 0;
        buf[wr] = v;
        valid[wr] = 1;
        bidx[wr] = frame;
        if (!was_valid) {
          count_valid += 1;
          count += 1;
        }
        wr = wr + 1 == W ? 0 : wr + 1;
        replenish = 1;
      }
      learned_total += learned;
      replenish_total += replenish;
      fsnu = learned + replenish > 0 ? 0 : fsnu + 1;
      // ---- adaptive q ----
      if (c.q_adapt) {
        float q = q_eff;
        if (replenish > 0) q = __fadd_rn(__fmul_rn(q, c.ra_keep), c.ra_add);
        if (learned > 0) q = __fadd_rn(__fmul_rn(q, c.na_keep), c.na_add);
        q_eff = clamp_nan(q, c.q_min, c.q_max);
      }
      // ---- the quantile's ranks ----
      const float h = __fmul_rn(q_eff, (float)max(count - 1, 0));
      sh[kShLo] = (int)floorf(h);
      sh[kShHi] = (int)ceilf(h);
      sh[kShSlotLo] = sh[kShSlotHi] = INT_MAX;
      sh[kShCount] = count;  // read back below, then cleared
    }
    __syncthreads();
    // the rank count of masked_quantile_rankselect: ties by slot, invalid
    // slots as FLT_MAX; the first slot holding each rank
    {
      const int lo = sh[kShLo], hi = sh[kShHi];
      for (int w = tid; w < W; w += kGenThreads) {
        const float xw = valid[w] ? buf[w] : FLT_MAX;
        int rank = 0;
        for (int s2 = 0; s2 < W; ++s2) {
          const float xs = valid[s2] ? buf[s2] : FLT_MAX;
          rank += (xs < xw || (xs == xw && s2 < w)) ? 1 : 0;
        }
        if (rank == lo) atomicMin(&sh[kShSlotLo], w);
        if (rank == hi) atomicMin(&sh[kShSlotHi], w);
      }
    }
    __syncthreads();

    if (tid == 0) {
      const int count = sh[kShCount];
      sh[kShCount] = 0;
      const int slo = sh[kShSlotLo] == INT_MAX ? 0 : sh[kShSlotLo];
      const int shi = sh[kShSlotHi] == INT_MAX ? 0 : sh[kShSlotHi];
      const float v_lo = valid[slo] ? buf[slo] : FLT_MAX, v_hi = valid[shi] ? buf[shi] : FLT_MAX;
      const float h = __fmul_rn(q_eff, (float)max(count - 1, 0));
      const float frac = __fsub_rn(h, (float)sh[kShLo]);
      const float qv = count > 0 ? lerp_rn(v_lo, v_hi, frac) : 0.f;
      // ---- the noise scalar (warm-up semantics) and its smoothing ----
      const bool warm = count_valid >= c.W_min;
      const float ema_new = __fadd_rn(__fmul_rn(c.ema_keep, ema), __fmul_rn(c.ema_a, qv));
      ema = warm ? ema_new : 0.f;
      if (!warm) ne_smooth = 0.f;
      const float n_sub = warm ? ema : 0.f;
      const float ne_raw = __fmul_rn(c.S_f, n_sub);
      float ne = ne_raw;
      if (c.smooth) {
        const float up = any_rain ? c.wet : c.dry;
        const float alpha = ne_raw > ne_smooth ? up : c.release;
        ne_smooth = __fadd_rn(__fmul_rn(__fsub_rn(1.f, alpha), ne_smooth), __fmul_rn(alpha, ne_raw));
        ne = ne_smooth;
      }
      // ---- telemetry ----
      const float Eb = io.Eb[ft];
      e_total = __fadd_rn(e_total, max_nan(Eb, 0.f));
      e_rain = __fadd_rn(e_rain, rain_e);
      e_noise = __fadd_rn(e_noise, min_nan(max_nan(ne, 0.f), max_nan(dry_e, 0.f)));
      min_valid = n_total == 0 ? count_valid : min(min_valid, count_valid);
      n_total += 1;
      underflow += count_valid < c.W_min ? 1 : 0;
      n_rain += any_rain ? 1 : 0;
      n_noise += any_rain ? 0 : 1;
      // ---- Wiener gain ----
      const float num = max_nan(__fsub_rn(Eb, __fmul_rn(c.beta, ne)), 0.f);
      const float g_pow = __fdiv_rn(num, __fadd_rn(Eb, c.eps));
      const float g = clamp_nan(__fsqrt_rn(clamp_nan(g_pow, 0.f, 1.f)), c.gain_floor, 1.f);
      const long long o = ft;
      const float fo[kOF] = {ne, ne_raw, g, __fmul_rn(io.Mb[ft], g), n_sub, e_noise, e_rain,
                             e_total, q_eff};
      const int io_[kOI] = {fft_rain, n_noise, n_rain, n_total, count_valid, min_valid,
                            underflow, fsnu, learned_total, replenish_total};
#pragma unroll
      for (int k = 0; k < kOF; ++k) io.of[k * plane + o] = fo[k];
#pragma unroll
      for (int k = 0; k < kOI; ++k) io.oi[k * plane + o] = io_[k];
    }
    __syncthreads();
  }

  if (tid == 0) {
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

cudaError_t launch_general(const BandIO& io, const BandConsts& c, cudaStream_t st) {
  const size_t smem = 12 * (size_t)c.S;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        band_scan_general, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  band_scan_general<<<c.B, kGenThreads, smem, st>>>(io, c);
  return cudaGetLastError();
}

template <int SPL, int S>
cudaError_t launch(const BandIO& io, const BandConsts& c, cudaStream_t st) {
  band_scan<SPL, S><<<c.B, 32, 0, st>>>(io, c);
  return cudaGetLastError();
}

template <int SPL>
cudaError_t launch_s(const BandIO& io, const BandConsts& c, cudaStream_t st) {
  switch (c.S) {
    case 1: return launch<SPL, 1>(io, c, st);
    case 2: return launch<SPL, 2>(io, c, st);
    case 3: return launch<SPL, 3>(io, c, st);
    case 4: return launch<SPL, 4>(io, c, st);
    case 5: return launch<SPL, 5>(io, c, st);
    case 6: return launch<SPL, 6>(io, c, st);
    case 7: return launch<SPL, 7>(io, c, st);
    default: return launch<SPL, 8>(io, c, st);
  }
}

}  // namespace

// io: BandIO, consts: BandConsts (models/band_noise.py::_BandIO,
// _BandConsts); S >= 1, W >= 1, B >= 1, T >= 0.  1 <= S <= 8 and
// S <= W <= 64 take the warp kernel, every other geometry the general one
// (models/band_noise.py::k6_route says the same).
extern "C" int apt_band_noise_scan(const void* io_ptr, const void* consts_ptr, void* stream) {
  const BandIO& io = *static_cast<const BandIO*>(io_ptr);
  const BandConsts& c = *static_cast<const BandConsts*>(consts_ptr);
  if (c.S < 1 || c.W < 1 || c.B < 1 || c.T < 0 || c.rq_lo < 0 || c.rq_hi >= c.S ||
      12LL * c.S > 232448)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (c.S > kMaxS || c.W < c.S || c.W > 64) return (int)launch_general(io, c, st);
  return (int)(c.W <= 32 ? launch_s<1>(io, c, st) : launch_s<2>(io, c, st));
}
