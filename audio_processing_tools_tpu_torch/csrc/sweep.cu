// K10: the spectral threshold sweep's decision counts, hand-written for
// Hopper (sm_90a).
//
// Replaces `eval_combo` of `grid_search_vmapped`
// (audio_processing_tools_tpu/tuning/grid_search.py:231-241), which the JAX
// package runs as `jax.jit(jax.vmap(eval_combo))` (:251).  It was not a
// Pallas kernel: XLA fuses the rule over the combo axis, so each combo reads
// the five (B, T) feature planes and writes one value per clip.  Eager
// PyTorch, broadcast over a combo axis, writes a (C, B, T) plane for each of
// the rule's ~15 operations (1.8 GB a plane at 4,096 x 128 x 873).
//
// What it computes, for combo c and clip b:
//
//   count[c, b] = sum_t [v0 >= pm_c] & ([v1 >= m1_c] + [v2 >= m2_c]
//                                       + [v3 >= m3_c] >= msc_c)
//
// with v_k = L_k[b, t] where crest[b, t] > tdg_c (the TD gate is open), else
// 0 * L_k[b, t].  The wrapper (ops/sweep.py) computes L_k = log1p(max(feat_k,
// 0)) once with torch, the same operations as the plain version, so the
// kernel only compares and counts.  JAX's f_k = log1p(max(feat_k * gate, 0))
// is L_k bit for bit where the gate is open; where it is closed, a finite
// feature gives +-0 on both sides (log1p(+-0) = +-0, and +-0 >= thr does not
// depend on the sign), and a NaN or +inf feature gives NaN on both sides
// (NaN * 0 and inf * 0 are NaN), which never counts.  The counts are
// integers: the kernel gives the plain version's values exactly.
//
// What bounds it on this card.  A grid repeats each threshold many times:
// the sweep's 4,096 combos hold 8 + 4 + 4 + 2 distinct flux thresholds and 4
// gate thresholds.  So the work these inputs need is one compare a distinct
// threshold and frame per clip, and one word operation a combo and 32 frames
// per clip (1.7e7 at 4,096 x 128 x 873, 0.5 us at one operation a lane a
// clock); the bytes are the five planes read once and the counts written
// once (2.2 MB + 2.1 MB, 1.3 us at 3.35 TB/s), which bind.
//
// Design: bit-sliced counts.
//  * The wrapper (ops/sweep.py::k10_plan) cuts the combos into slices of S
//    and finds, for each slice and each of the four flux axes, the distinct
//    (gate threshold, flux threshold) pairs of its combos (by bit pattern,
//    so a NaN threshold stays itself) and each combo's row among them.  It
//    picks the largest slice that still gives a block an SM and whose rows
//    fit 48 KB of shared memory: the sweep's 4,096 combos go in 2 slices of
//    2,048 with 56 rows each; a grid whose every threshold is distinct in
//    slices of 64 with 256 rows.
//  * One block per (slice, clip).  It loads its clip's frames for the
//    words its warp takes and its slice's rows.  Masks: for each row and
//    each word of 32 frames, a warp's lanes take the word's frames and one
//    __ballot_sync gives the frames where v_k >= thr, v_k being L_k or 0 *
//    L_k as the row's gate opens or closes on that frame: the rule's own
//    float compares, once a pair, not once a combo.  A warp takes up to
//    kWordsPerWarp words at a time, their frames' five values in
//    registers; frames past T give zero bits.  Mask rows live in shared
//    memory at an odd pitch of words.
//  * Counts: a combo's four pass words per 32 frames; hits >= msc is read
//    from the bit-sliced sum of the three support words (s0 = the xor,
//    s1 = the majority): msc <= 0 all frames, 1 s0 | s1, 2 s1, 3 s0 & s1,
//    >= 4 none.  Then an and with the primary word, __popc and an add.
//    One thread takes a combo and walks its words, with no reduction (the
//    rows a warp reads fall on distinct banks, the pitch being odd); a warp
//    a combo, its lanes over the words and a warp reduce, took 4.8 times as
//    long on the sweep (tools/time_k5_k10.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWordsPerWarp = 4;         // words a warp's lanes hold in registers at a time
constexpr int kMaxSharedBytes = 232448;  // 227 KB a block

// words of 32 frames, and the pitch of a mask row: odd, so that rows r and
// r' of one word fall on distinct banks unless r - r' is a multiple of 32
__host__ __device__ inline int words_of(int T) { return (T + 31) / 32; }
__host__ __device__ inline int pitch_of(int T) { return words_of(T) | 1; }

// shared bytes of a block: P mask rows and their (gate, flux) pairs
size_t shared_bytes(int P, int T) { return (size_t)P * (4 * (size_t)pitch_of(T) + sizeof(float2)); }

// [hits >= msc] from the support words: s0 (hits odd), s1 (hits >= 2),
// all = ~0 where msc <= 0, x = ~0 where msc == 1, two = msc == 2
__device__ __forceinline__ uint32_t rain_word(uint32_t p0, uint32_t p1, uint32_t p2, uint32_t p3,
                                              uint32_t all, uint32_t x, bool two) {
  const uint32_t s0 = p1 ^ p2 ^ p3;
  const uint32_t s1 = (p1 & p2) | (p1 & p3) | (p2 & p3);
  // msc 1: s0 | s1, msc 3: s0 & s1 (the majority of s0, s1 and x)
  const uint32_t ge = two ? s1 : ((s0 & s1) | (x & (s0 | s1)));
  return p0 & (ge | all);
}

__global__ void __launch_bounds__(kThreads)
decision_sweep_kernel(const float* __restrict__ logs,   // (4, B, T): L0..L3
                      const float* __restrict__ crest,  // (B, T)
                      const float2* __restrict__ rows,  // (n_slices, P): (tdg, thr)
                      const int* __restrict__ offs,     // (n_slices, 5): axis starts, count
                      const int4* __restrict__ index,   // (n_slices * S,): a combo's rows
                      const int* __restrict__ msc,      // (C,)
                      int* __restrict__ counts,         // (C, B)
                      int B, int T, int C, int S, int P) {
  extern __shared__ float2 smem[];
  const int W = words_of(T), pitch = pitch_of(T);
  float2* const tab = smem;                                          // [P]
  uint32_t* const masks = reinterpret_cast<uint32_t*>(smem + P);     // [P][pitch]
  const int s = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int off[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) off[k] = offs[s * 5 + k];

  // this warp's first words of frames, loaded before the rows' barrier
  const size_t plane = (size_t)B * T;
  const size_t row = (size_t)b * T;
  float cr[kWordsPerWarp], l[kWordsPerWarp][4];
  bool in[kWordsPerWarp];
  auto load_words = [&](int w0) {
#pragma unroll
    for (int u = 0; u < kWordsPerWarp; ++u) {
      const int t = (w0 + u) * 32 + lane;
      in[u] = w0 + u < W && t < T;
      cr[u] = in[u] ? crest[row + t] : 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) l[u][k] = in[u] ? logs[k * plane + row + t] : 0.f;
    }
  };
  int w0 = warp * kWordsPerWarp;
  if (w0 < W) load_words(w0);
  for (int i = threadIdx.x; i < off[4]; i += kThreads) tab[i] = rows[(size_t)s * P + i];
  __syncthreads();

  // ---- masks: a ballot a (row, word) --------------------------------------
  for (; w0 < W; w0 += kWarps * kWordsPerWarp) {
    if (w0 != warp * kWordsPerWarp) load_words(w0);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float z[kWordsPerWarp];  // the closed gate's values: +-0, NaN for NaN or inf
#pragma unroll
      for (int u = 0; u < kWordsPerWarp; ++u) z[u] = __fmul_rn(l[u][k], 0.f);
#pragma unroll 2
      for (int r = off[k]; r < off[k + 1]; ++r) {
        const float2 p = tab[r];  // (tdg, thr), the same for every lane
        uint32_t bits[kWordsPerWarp];
#pragma unroll
        for (int u = 0; u < kWordsPerWarp; ++u) {
          const float v = cr[u] > p.x ? l[u][k] : z[u];
          bits[u] = __ballot_sync(0xffffffffu, in[u] && v >= p.y);
        }
        // lane u stores word w0 + u of the row
        uint32_t mine = bits[0];
#pragma unroll
        for (int u = 1; u < kWordsPerWarp; ++u) mine = lane == u ? bits[u] : mine;
        if (lane < kWordsPerWarp && w0 + lane < W) masks[(size_t)r * pitch + w0 + lane] = mine;
      }
    }
  }
  __syncthreads();

  // ---- counts --------------------------------------------------------------
  const int c0 = s * S;
  for (int i = threadIdx.x; i < S && c0 + i < C; i += kThreads) {
    const int c = c0 + i;
    const int4 ix = index[c];
    const int ms = msc[c];
    const uint32_t all = ms <= 0 ? 0xffffffffu : 0u, x = ms == 1 ? 0xffffffffu : 0u;
    const bool two = ms == 2;
    const uint32_t* const r0 = masks + (size_t)ix.x * pitch;
    const uint32_t* const r1 = masks + (size_t)ix.y * pitch;
    const uint32_t* const r2 = masks + (size_t)ix.z * pitch;
    const uint32_t* const r3 = masks + (size_t)ix.w * pitch;
    int cnt = 0;
#pragma unroll 4
    for (int w = 0; w < W; ++w) cnt += __popc(rain_word(r0[w], r1[w], r2[w], r3[w], all, x, two));
    counts[(size_t)c * B + b] = ms >= 4 ? 0 : cnt;
  }
}

}  // namespace

// logs (4, B, T), crest (B, T), rows (n_slices, P, 2), offs (n_slices, 5),
// index (n_slices * S, 4) int32, msc (C,), counts (C, B): the tables of
// ops/sweep.py::k10_plan for slices of S combos; refused when P rows do not
// fit a block's shared memory.
extern "C" int apt_decision_sweep(const float* logs, const float* crest, const float* rows,
                                  const int* offs, const int* index, const int* msc,
                                  int* counts, int B, int T, int C, int S, int P, void* stream) {
  if (B <= 0 || T <= 0 || C <= 0 || S <= 0 || P < 4 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t shared = shared_bytes(P, T);
  if (shared > (size_t)kMaxSharedBytes) return (int)cudaErrorInvalidValue;
  const long long n_slices = ((long long)C + S - 1) / S;
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decision_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
    if (err != cudaSuccess) return (int)err;
  }
  decision_sweep_kernel<<<dim3((unsigned)n_slices, (unsigned)B), kThreads, shared,
                          (cudaStream_t)stream>>>(
      logs, crest, reinterpret_cast<const float2*>(rows), offs,
      reinterpret_cast<const int4*>(index), msc, counts, B, T, C, S, P);
  return (int)cudaGetLastError();
}
