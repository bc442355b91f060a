// K7: the cascaded-biquad filter with initial and final state, scipy's
// `sosfilt(sos, x, zi=zi)` -> (y, zf), hand-written for Hopper (sm_90a).
//
// It replaces `_sosfilt_section_pscan`
// (audio_processing_tools_tpu/ops/filters.py:290-411), the per-section
// blocked two-level parallel scan that `sosfilt(..., zi=...)` runs
// (:669-712).  Its one caller on the product path is the streaming
// detector's causal TD prefilter (models/streaming.py:636-637), which
// carries `zi` from one chunk of a live stream to the next.
//
// What bounds it on this card.  At the live batch (64 streams x 22,272
// samples, a 2 s chunk) the bytes are 5.7 MB in and 5.7 MB out, 3.4 us at
// 3.35 TB/s.  But each sample of a section waits for the one before:
// z0 -> y = b0 x + z0 -> a1 y -> (b1 x - a1 y) -> + z1 -> z0 is four
// dependent float operations, 17 cycles on the H100 (tools/time_k6_k7.py
// times one thread's step), so one stream takes ~22,272 x 17 cycles, about
// 0.19 ms at 1.98 GHz, whatever the card's width.  The chain sets the time.
//
// Design: one block per stream, its sections pipelined over tiles of the
// row in a shared-memory ring.  Warp 0 is the loader: it brings each tile of
// x in with one TMA bulk copy (16-byte aligned body; scalar loads for a row's
// unaligned head and its tail) that completes on the tile's "loaded"
// mbarrier, and stores each finished tile of y back with 16-byte stores.
// Warp 1 + w is walker w, whose lane 0 runs section w (kSectionsPerWalker
// sections) over a tile in place, reading and writing four samples at a time
// (ld.shared.v4 / st.shared.v4), then arrives on the tile's next mbarrier;
// walker w takes tile k while walker w - 1 takes tile k + 1.  So a walker
// issues ~10 instructions a sample under its 17-cycle chain, and the loads,
// stores and other sections stay off it; a row takes about (tiles + walkers
// - 1) tiles' chains.  The ring holds walkers + 2 tiles, so the loader
// fills tile k + walkers + 1 while tile k - 1 is stored.
//
// Every section still walks the samples in order, which is the definition
// of the filter, so the result does not depend on where a stream is cut into
// chunks: chunk invariance holds bit for bit at every cut, which the JAX
// blocked scan, anchored at the chunk start, does not give.
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

#include <cstdint>

namespace {

constexpr int kMaxSections = 8;        // second-order sections the launcher takes
constexpr int kSectionsPerWalker = 1;  // sections one walker thread runs in turn: 1 or 2
constexpr int kTileLong = 1024;        // samples a tile in a row of kLongRow or more
constexpr int kTileShort = 128;        // samples a tile in a shorter row
constexpr long long kLongRow = 8192;
constexpr int kMaxWalkers = (kMaxSections + kSectionsPerWalker - 1) / kSectionsPerWalker;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void bar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void bar_arrive_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// until the phase of parity `parity` of `bar` has completed
__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}
// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(float* dst, const float* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// where tile k of a row lies: slot positions [lo, hi) hold samples
// base + lo .. base + hi - 1; [a, b) is the body whose global address is
// 16-byte aligned (empty when b <= a)
struct TileSpan {
  long long base;
  int lo, hi, a, b;
};
__device__ __forceinline__ TileSpan span_of(long long k, int tile, int lead, long long n) {
  TileSpan t;
  t.base = k * tile - lead;
  t.lo = k == 0 ? lead : 0;
  t.hi = (int)min((long long)tile, n - t.base);
  t.a = (t.lo + 3) & ~3;
  t.b = t.hi & ~3;
  return t;
}

// Walker w's G sections (s0 .. s0 + G - 1) over every tile of row r, in
// place; the sections' state stays in registers, and the loop over a tile
// has no branch but its own.
template <int G>
__device__ __forceinline__ void walk(float* ring, uint64_t* bars, int nb, int tile, int lead,
                                     long long n_tiles, long long n, const float* coef,
                                     const float* zi, float* zf, int r, int S, int w, int s0) {
  float b0[G], b1[G], b2[G], a1[G], a2[G], z0[G], z1[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int s = s0 + g;
    b0[g] = coef[5 * s];
    b1[g] = coef[5 * s + 1];
    b2[g] = coef[5 * s + 2];
    a1[g] = coef[5 * s + 3];
    a2[g] = coef[5 * s + 4];
    z0[g] = zi[((long long)r * S + s) * 2];
    z1[g] = zi[((long long)r * S + s) * 2 + 1];
  }
  // one sample through the walker's sections
  auto step = [&](float v) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float out = __fadd_rn(__fmul_rn(b0[g], v), z0[g]);
      z0[g] = __fadd_rn(__fsub_rn(__fmul_rn(b1[g], v), __fmul_rn(a1[g], out)), z1[g]);
      z1[g] = __fsub_rn(__fmul_rn(b2[g], v), __fmul_rn(a2[g], out));
      v = out;
    }
    return v;
  };
  uint64_t* done = &bars[(w + 1) * nb];
  for (long long k = 0; k < n_tiles; ++k) {
    const int slot = (int)(k % nb);
    bar_wait(&bars[w * nb + slot], (unsigned)((k / nb) & 1));
    float* s = ring + (size_t)slot * tile;
    const TileSpan t = span_of(k, tile, lead, n);
    int p = t.lo;
    for (; p < t.hi && (p & 3); ++p) s[p] = step(s[p]);
    const int pe = p + ((t.hi - p) & ~3);
    if (p < pe) {
      float4 cur = *reinterpret_cast<const float4*>(s + p);
      for (; p < pe; p += 4) {
        // the next four samples are read while these four are filtered
        const float4 nxt = p + 4 < pe ? *reinterpret_cast<const float4*>(s + p + 4) : cur;
        cur.x = step(cur.x);
        cur.y = step(cur.y);
        cur.z = step(cur.z);
        cur.w = step(cur.w);
        *reinterpret_cast<float4*>(s + p) = cur;
        cur = nxt;
      }
    }
    for (; p < t.hi; ++p) s[p] = step(s[p]);
    bar_arrive(&done[slot]);
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    zf[((long long)r * S + s0 + g) * 2] = z0[g];
    zf[((long long)r * S + s0 + g) * 2 + 1] = z1[g];
  }
}

// x, y: (R, n); coef: (S, 5); zi, zf: (R, S, 2).  One block per row: warp 0
// loads and stores, warp 1 + w walks sections w * kSectionsPerWalker on.
__global__ void __launch_bounds__(32 * (kMaxWalkers + 1))
sosfilt_zi(const float* __restrict__ x, const float* __restrict__ coef,
           const float* __restrict__ zi, float* __restrict__ y, float* __restrict__ zf,
           long long n, int S, int walkers, int tile) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nb = walkers + 2;  // ring slots
  float* ring = reinterpret_cast<float*>(smem);
  // bars[stage * nb + slot]: stage 0 loaded, stage 1 + w walked by walker w
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + (size_t)nb * tile);
  const int r = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* xr = x + (long long)r * n;
  float* yr = y + (long long)r * n;
  // the row starts `lead` samples past a 16-byte boundary; tile k covers
  // samples k * tile - lead .. (k + 1) * tile - lead - 1
  const int lead = (int)((reinterpret_cast<uintptr_t>(xr) >> 2) & 3);
  const bool y_aligned =
      ((reinterpret_cast<uintptr_t>(yr) ^ reinterpret_cast<uintptr_t>(xr)) & 15) == 0;
  const long long n_tiles = n == 0 ? 0 : (n + lead + tile - 1) / tile;

  if (threadIdx.x == 0) {
    for (int i = 0; i < (walkers + 1) * nb; ++i) bar_init(&bars[i], i < nb ? 32 : 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 0) {
    // ---- the loader ----
    auto load = [&](long long k) {
      const int slot = (int)(k % nb);
      float* s = ring + (size_t)slot * tile;
      const TileSpan t = span_of(k, tile, lead, n);
      const bool body = t.b > t.a;
      const int e0 = body ? t.a : t.hi;  // scalar head [lo, e0), tail [e1, hi)
      const int e1 = body ? t.b : t.hi;
      for (int p = t.lo + lane; p < e0; p += 32) s[p] = xr[t.base + p];
      for (int p = e1 + lane; p < t.hi; p += 32) s[p] = xr[t.base + p];
      __syncwarp();
      uint64_t* bar = &bars[slot];
      if (lane == 0) {
        // the slot's last tile was read and written by generic stores; the
        // copy below writes it through the async proxy
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        const unsigned bytes = body ? 4u * (unsigned)(t.b - t.a) : 0u;
        bar_arrive_tx(bar, bytes);
        if (body) bulk_load(s + t.a, xr + t.base + t.a, bytes, bar);
      } else {
        bar_arrive(bar);
      }
    };
    for (long long k = 0; k < min((long long)nb, n_tiles); ++k) load(k);
    for (long long k = 0; k < n_tiles; ++k) {
      const int slot = (int)(k % nb);
      bar_wait(&bars[walkers * nb + slot], (unsigned)((k / nb) & 1));
      const float* s = ring + (size_t)slot * tile;
      const TileSpan t = span_of(k, tile, lead, n);
      if (y_aligned && t.b > t.a) {
        for (int p = t.a + 4 * lane; p < t.b; p += 128)
          *reinterpret_cast<float4*>(yr + t.base + p) = *reinterpret_cast<const float4*>(s + p);
        for (int p = t.lo + lane; p < t.a; p += 32) yr[t.base + p] = s[p];
        for (int p = t.b + lane; p < t.hi; p += 32) yr[t.base + p] = s[p];
      } else {
        for (int p = t.lo + lane; p < t.hi; p += 32) yr[t.base + p] = s[p];
      }
      __syncwarp();
      if (k + nb < n_tiles) load(k + nb);
    }
    return;
  }

  // ---- walker w: sections s0 .. s0 + ns - 1, lane 0 ----
  const int w = warp - 1;
  if (lane != 0 || w >= walkers) return;
  const int s0 = w * kSectionsPerWalker;
  const int ns = min(kSectionsPerWalker, S - s0);
  if (kSectionsPerWalker == 2 && ns == 2)
    walk<2>(ring, bars, nb, tile, lead, n_tiles, n, coef, zi, zf, r, S, w, s0);
  else
    walk<1>(ring, bars, nb, tile, lead, n_tiles, n, coef, zi, zf, r, S, w, s0);
}

}  // namespace

// x, y: (R, n) contiguous; coef: (S, 5) = b0, b1, b2, a1, a2 per section
// (a0 = 1); zi, zf: (R, S, 2) contiguous.  1 <= S <= 8.
extern "C" int apt_sosfilt_zi(const float* x, const float* coef, const float* zi, float* y,
                              float* zf, int R, long long n, int S, void* stream) {
  if (R <= 0 || n < 0 || S < 1 || S > kMaxSections) return (int)cudaErrorInvalidValue;
  const int walkers = (S + kSectionsPerWalker - 1) / kSectionsPerWalker;
  const int tile = n >= kLongRow ? kTileLong : kTileShort;
  const size_t shared = (size_t)(walkers + 2) * tile * sizeof(float) +
                        (size_t)(walkers + 1) * (walkers + 2) * sizeof(uint64_t);
  sosfilt_zi<<<R, 32 * (walkers + 1), shared, (cudaStream_t)stream>>>(x, coef, zi, y, zf, n, S,
                                                                      walkers, tile);
  return (int)cudaGetLastError();
}
