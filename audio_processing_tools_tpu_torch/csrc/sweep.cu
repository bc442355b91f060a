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
// What bounds it on this card: issue.  Bytes are five planes read and the
// counts written, 2.2 MB + 2.1 MB at 4,096 combos x 128 clips x 873 frames
// (1.3 us at 3.35 TB/s); the rule is 11 one-lane operations for each of the
// 4.6e8 (combo, clip, frame) triples (5 compares, 3 adds, a compare, an and,
// an add), 0.15 ms at one operation a lane a clock (132 SMs x 128 lanes x
// 1.98 GHz).
//
// Design: one block of 256 threads per (clip, slice of 256 combos).  The
// block stages its clip's five planes in shared memory (20 bytes a frame:
// 17.5 KB at 873 frames).  Each warp takes 32 combos in four passes of
// eight; in a pass its lanes split the frames, each lane reads a frame's
// five values once and evaluates the pass's eight combos on them, and a
// warp-wide integer reduce gives each combo's count.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPass = 8;                                  // combos per frame read
constexpr int kCombosPerWarp = 32;
constexpr int kCombosPerBlock = kWarps * kCombosPerWarp;  // 256
constexpr int kMaxSharedBytes = 232448;                   // 227 KB a block

__global__ void __launch_bounds__(kThreads)
decision_sweep_kernel(const float* __restrict__ logs,   // (4, B, T): L0..L3
                      const float* __restrict__ crest,  // (B, T)
                      const float* __restrict__ thr,    // (C, 5): pm, m1, m2, m3, tdg
                      const int* __restrict__ msc,      // (C,)
                      int* __restrict__ counts,         // (C, B)
                      int B, int T, int C) {
  extern __shared__ float s[];  // crest, L0, L1, L2, L3: T values each
  const int b = blockIdx.x;
  const size_t plane = (size_t)B * T;
  const size_t row = (size_t)b * T;
  for (int t = threadIdx.x; t < T; t += kThreads) {
    s[t] = crest[row + t];
#pragma unroll
    for (int k = 0; k < 4; ++k) s[(k + 1) * T + t] = logs[k * plane + row + t];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c_warp = blockIdx.y * kCombosPerBlock + warp * kCombosPerWarp;
  for (int p = 0; p < kCombosPerWarp; p += kPass) {
    const int c0 = c_warp + p;
    if (c0 >= C) break;
    float pm[kPass], m1[kPass], m2[kPass], m3[kPass], tdg[kPass];
    int ms[kPass], cnt[kPass];
#pragma unroll
    for (int j = 0; j < kPass; ++j) {
      const int c = min(c0 + j, C - 1);  // past C: the last combo again, not written
      pm[j] = thr[c * 5 + 0];
      m1[j] = thr[c * 5 + 1];
      m2[j] = thr[c * 5 + 2];
      m3[j] = thr[c * 5 + 3];
      tdg[j] = thr[c * 5 + 4];
      ms[j] = msc[c];
      cnt[j] = 0;
    }
    for (int t = lane; t < T; t += 32) {
      const float cr = s[t];
      const float l0 = s[T + t], l1 = s[2 * T + t], l2 = s[3 * T + t], l3 = s[4 * T + t];
      // the closed gate's values: +-0, NaN where L is NaN or inf
      const float z0 = __fmul_rn(l0, 0.f), z1 = __fmul_rn(l1, 0.f);
      const float z2 = __fmul_rn(l2, 0.f), z3 = __fmul_rn(l3, 0.f);
#pragma unroll
      for (int j = 0; j < kPass; ++j) {
        const bool open = cr > tdg[j];
        const float v0 = open ? l0 : z0, v1 = open ? l1 : z1;
        const float v2 = open ? l2 : z2, v3 = open ? l3 : z3;
        const int hits = (int)(v1 >= m1[j]) + (int)(v2 >= m2[j]) + (int)(v3 >= m3[j]);
        cnt[j] += (int)((v0 >= pm[j]) & (hits >= ms[j]));
      }
    }
#pragma unroll
    for (int j = 0; j < kPass; ++j) {
      const int total = __reduce_add_sync(0xffffffffu, cnt[j]);
      if (lane == 0 && c0 + j < C) counts[(size_t)(c0 + j) * B + b] = total;
    }
  }
}

}  // namespace

extern "C" int apt_decision_sweep(const float* logs, const float* crest, const float* thr,
                                  const int* msc, int* counts, int B, int T, int C,
                                  void* stream) {
  const long long grid_y = ((long long)C + kCombosPerBlock - 1) / kCombosPerBlock;
  const long long shared = 5LL * 4 * T;
  if (B <= 0 || T <= 0 || C <= 0 || grid_y > 65535 || shared > kMaxSharedBytes)
    return (int)cudaErrorInvalidValue;
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decision_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
    if (err != cudaSuccess) return (int)err;
  }
  decision_sweep_kernel<<<dim3(B, (unsigned)grid_y), kThreads, (size_t)shared,
                          (cudaStream_t)stream>>>(logs, crest, thr, msc, counts, B, T, C);
  return (int)cudaGetLastError();
}
