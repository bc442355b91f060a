// K11-K13: the shape of peaks along a row (local maxima, prominences and
// widths), as the JAX package computes them, hand-written for Hopper
// (sm_90a).
//
// Replaces three stages of audio_processing_tools_tpu/ops/peaks.py that XLA
// compiles into one fused program each and eager PyTorch runs as many
// passes over materialised planes: `local_maxima` (:27-71, two
// `lax.cummax` scans), `peak_prominences` (:74-105) and `peak_widths_rel`
// (:108-163), both O(n^2) masked planes.  None was a Pallas kernel.
//
// Rows.  The lane routes read rows where the caller keeps them and write
// their outputs in the same layout: rows as columns (T > 0: row r = b T + t
// at x + b n T + t, positions of stride T; the peak gate's
// `spec.transpose(-1, -2)` and RoE's `mag.transpose(-1, -2)`), where a warp
// takes neighbouring rows of one b, so a position is one coalesced segment
// across the warp, copied in with cp.async and written out a position at a
// time; and, for K12, contiguous rows (T = 0: row r at x + r n), where a
// warp copies its tile of whole rows in and stores its outputs from shared
// memory with 16-byte stores (aligned where the base pointers are: a tile
// is a multiple of 16 rows).  The other routes take contiguous rows;
// ops/peaks.py copies any other layout.
//
// K11, local_maxima.  A position m is marked where its plateau [s, e] (the
// run of equal samples around it; NaN equals nothing) is entered by a rise,
// left by a fall, and m = (s + e) / 2.  Boundary j (between samples j and
// j + 1) is a change where x[j + 1] != x[j], a rise where x[j + 1] > x[j],
// a fall where x[j + 1] < x[j]: the JAX function's comparisons, and the
// rest is integer work, so the mask is exact.
//  * Lane route (rows as columns, n up to kLaneMax11): a lane a row, 32
//    rows a warp, the whole column in shared memory by cp.async in two
//    groups, the first scanned while the second lands.  The lane scans
//    from the left carrying the last change boundary and whether it rose,
//    overwrites each sample with its mark (0), and where a change closes a
//    plateau entered by a rise and left by a fall marks its midpoint,
//    behind the step.  No branch: the gate's dB rows hold long plateaus at
//    their 0 floor, and a loop over a closing plateau would hold the
//    warp's other lanes.
//  * Warp route (contiguous rows, any n): a warp a row,
//    chunks of 128 positions (4 a lane), a warp max-scan of the JAX codes
//    j * 2 + up carried across chunks, a chunk zeroed before its marks,
//    which land in the chunk or an earlier one.
//
// K12, peak_prominences.  For a peak p, each side extends from p to the
// first strictly higher sample (a NaN never stops it) or the border; the
// side's base is its minimum, p included, with NaN propagating as
// `torch.amin` and `jnp.min` do; the prominence is x[p] - max(bases), NaN
// propagating as `torch.maximum` does, and +0.0 off the peaks.
//  * Lane route (n up to kLaneMax12): two lanes a row, one for each side,
//    16 rows a warp, O(n) a side with jump pointers: L[i], the previous
//    strictly higher sample, and B[i], the minimum over (L[i], i] (the left
//    base), found by following L from i - 1 and merging the B of each
//    sample passed; each sample is passed at most once.  A NaN x[i] passes
//    nothing (L[i] = i - 1, B[i] = NaN) and is passed by every later
//    sample, carrying NaN into its base; an equal sample is passed.  The
//    right side does the same with R.  Each lane runs its own sequence of
//    steps (follow a pointer, or settle a position), so no lane waits for
//    another's longer chain (prominence_lane says how).
//  * Table route (n up to kSharedMax): a warp a row, range tables of the
//    row in shared memory, floor(log2 n) levels of maxima (NaN read as
//    lower than anything: fmaxf) and of minima that propagate NaN; a lane
//    a peak (queued 32 at a time) finds each side's nearest strictly higher
//    sample by descending the maxima, one level a step, and reads each
//    base as the minimum of two overlapping entries.
//  * Walk route (any n; past kSharedMax from device memory): a warp a row,
//    a lane a peak walking both sides.
// Every step is a comparison, so the values are exact.  Where a minimum
// ties -0.0 with +0.0 the lane and walk routes keep the one nearer p and
// the table route either: the plain version's choice depends on its
// reduction order, so such a zero can differ in sign only (x[p] = -0.0
// against a base of +0.0).
//
// K13, peak_widths_rel.  For a peak p, h = x[p] - rel_height * prom[p]
// (the product rounded, then the difference), the last sample at or below
// h left of p and the first right of p, each crossing interpolated
// linearly, width = right - left; the JAX function's operations one by one
// (`_rn` intrinsics: no contraction into an FMA, IEEE division), a picked
// sample + 0.0 as the plain version's one-hot sum makes it (`width_of`).
// A NaN sample never stops a walk; a NaN h walks to the border.
//  * Lane route (rows as columns, n up to kLaneMax13): persistent warps, a
//    tile of 32 rows at a time and the next one copied in meanwhile; x
//    staged by cp.async a position a row, the mask as the aligned words
//    that hold its bytes; each lane keeps its row's peaks as bits and
//    writes +0.0 over the row, a scan of the counts across the lanes lists
//    the tile's peaks with their prominences, and the lanes take the list
//    32 at a time, each walking its peak's two sides in shared memory
//    (width_lane).
//  * Walk route (any n, contiguous rows): a warp a row read from device
//    memory, the peaks queued 32 at a time, a lane a peak.  Staged in
//    shared memory, as K12's walk is, it lost at 71-384 and 2,048
//    positions and won by 5% at 1,025 (PERF.md).
//
// What bounds them on this card: bytes.  K11 reads 4 bytes a position and
// writes 1; K12 reads 5 and writes 4; K13 reads 5 and writes 4 (x and
// the mask), and the prominences only at the peaks.  The lane routes take
// a row a position at a time, so at the gate's rows of 71 the instructions
// they execute, and for K13 the share of the SM's memory left to L1 for
// cp.async's lines, bound them before the bytes do (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;            // rows a block of the warp routes, one warp each
constexpr int kPer = 4;              // K11 warp route: positions a lane takes in a chunk
constexpr int kChunk = 32 * kPer;    // K11 warp route: positions a warp takes in a chunk
constexpr int kLaneRows12 = 16;      // K12 lane route: rows a warp takes, two lanes each
// the routes' row lengths, twinned in ops/peaks.py (K11_LANE_MAX,
// K12_LANE_MAX, K13_LANE_MAX, PEAK_SHAPE_SHARED_MAX)
constexpr int kLaneMax11 = 256;      // K11's lane route
constexpr int kLaneMax12 = 255;      // K12's lane route (pointers in bytes)
constexpr int kLaneMax13 = 160;      // K13's lane route (a multiple of 32)
constexpr int kPitch13 = 33;         // K13 lane route: floats a position (32 rows and a bank)
constexpr int kSharedMax = 2048;     // K12's table route and its walks in shared memory
constexpr int kQueue = 64;           // K12/K13: a warp's queue of peak positions
constexpr size_t kTableSmem = 200 * 1024;  // K12's table route: shared memory a block aims for
constexpr unsigned kFull = 0xffffffffu;

// dynamic shared memory past 48 KB is allowed per kernel
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// get(row, position) of a warp's tile of cnt whole rows to the cnt * n
// contiguous elements at g, a warp together, 16-byte stores where g is
// aligned
template <typename T, class Get>
__device__ void store_rows(T* __restrict__ g, int cnt, int n, int lane, Get get) {
  constexpr int V = 16 / sizeof(T);
  const int total = cnt * n;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(g) & 15) == 0) {
    const int chunks = total / V;
    for (int c = lane; c < chunks; c += 32) {
      union {
        uint4 u;
        T e[V];
      } v;
      int r = c * V / n, f = c * V - r * n;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        v.e[k] = get(r, f);
        if (++f == n) f = 0, ++r;
      }
      reinterpret_cast<uint4*>(g)[c] = v.u;
    }
    done = chunks * V;
  }
  for (int i = done + lane; i < total; i += 32) {
    const int r = i / n;
    g[i] = get(r, i - r * n);
  }
}

// A warp's tile of rows: in columns `per` neighbouring rows of one b (row
// r's lane at x + base, positions of stride T), in rows `per` consecutive
// rows (base: the tile's first element)
struct Tile {
  long long base;
  int cnt;  // rows in the tile
};
__device__ __forceinline__ Tile tile_of(long long g, long long rows, int n, long long T, int r,
                                        int per = 32) {
  if (T > 0) {
    const long long per_b = (T + per - 1) / per, b = g / per_b, t0 = (g % per_b) * per;
    return {b * n * T + t0 + r, (int)min((long long)per, T - t0)};
  }
  const long long row0 = g * per;
  return {row0 * n, (int)min((long long)per, rows - row0)};
}

// K11's scan of one row from the left, a position a step, over the row
// at xs[f * stride] (shared memory), which it overwrites with the marks:
// each position 0 at its own step, and where the change at boundary
// f - 1 closes a plateau entered by a rise and left by a fall, 1 at its
// midpoint, behind the step.  No branch, so lanes on different rows keep
// step whatever their plateaus.  scan(f0, f1) takes positions f0 .. f1 - 1
// in order, from f0 = 0.
struct MaximaScan {
  float* xs;
  int stride;
  float prev = 0.f;
  int c = -1, rise = 0;  // the last change boundary, and whether it rose
  __device__ __forceinline__ void scan(int f0, int f1) {
    int* mark = reinterpret_cast<int*>(xs);
    if (f0 == 0 && f1 > 0) {
      prev = xs[0];
      mark[0] = 0;
      f0 = 1;
    }
#pragma unroll 4
    for (int f = f0; f < f1; ++f) {
      const float v = xs[f * stride];
      mark[f * stride] = 0;
      const bool chg = v != prev;
      if (chg && rise && v < prev) mark[((c + f) >> 1) * stride] = 1;
      c = chg ? f - 1 : c;
      rise = chg ? (int)(v > prev) : rise;
      prev = v;
    }
  }
};

// K11 lane route on rows as columns: a lane a row; each lane copies its
// whole column into shared memory at once (cp.async, every position in
// flight, in two groups), scans it in place (a position's sample becomes
// its mark), and the warp stores the marks a position at a time, 32 bytes
// together
__global__ void __launch_bounds__(32)
local_maxima_lane_cols(const float* __restrict__ x, uint8_t* __restrict__ out, long long T,
                       int n) {
  extern __shared__ float col[];  // col[f * 32 + lane]: x, then the mark
  const int lane = threadIdx.x;
  const Tile tl = tile_of(blockIdx.x, 0, n, T, lane);
  if (lane >= tl.cnt) return;  // no lane waits on another
  // two groups: the first half is scanned while the second arrives
  const int half = (n + 1) / 2;
  for (int f = 0; f < n; ++f) {
    cp_async4(&col[f * 32 + lane], x + tl.base + (long long)f * T);
    if (f + 1 == half) cp_async_commit();
  }
  cp_async_commit();
  MaximaScan scan{col + lane, 32};
  cp_async_wait<1>();
  scan.scan(0, half);
  cp_async_wait<0>();
  scan.scan(half, n);
  const int* mark = reinterpret_cast<const int*>(col);
  for (int f = 0; f < n; ++f) out[tl.base + (long long)f * T] = (uint8_t)mark[f * 32 + lane];
}

// K11 warp route on rows of n < 2^30 positions with int codes, longer ones with 64-bit
template <typename I>
__global__ void __launch_bounds__(kWarps * 32)
local_maxima_kernel(const float* __restrict__ x, uint8_t* __restrict__ out, long long rows, I n) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps: nothing below waits on the block
  const float* xr = x + (size_t)row * (size_t)n;
  uint8_t* orow = out + (size_t)row * (size_t)n;
  I carry = -1;  // the last change boundary before the chunk, encoded
  for (I base = 0; base < n; base += kChunk) {
    const I q = base + (I)(kPer * lane);
    float v[kPer + 1];
#pragma unroll
    for (int k = 0; k <= kPer; ++k) v[k] = q + k < n ? xr[q + k] : 0.f;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (q + k < n) orow[q + k] = 0;
    }
    // boundary j = q + k sits between samples j and j + 1
    I code[kPer];
    bool fall[kPer];
    I lane_max = -1;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const I j = q + k;
      const bool inside = j <= n - 2;
      const float a = v[k], b = v[k + 1];
      code[k] = inside && b != a ? j * 2 + (b > a ? 1 : 0) : (I)-1;
      fall[k] = inside && b < a;
      lane_max = code[k] > lane_max ? code[k] : lane_max;
    }
    I incl = lane_max;  // inclusive max-scan of the lanes' codes
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const I t = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl = t > incl ? t : incl;
    }
    I run = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) run = -1;
    run = carry > run ? carry : run;
    const I total = __shfl_sync(kFull, incl, 31);
    __syncwarp();  // the chunk's zeros before any mark
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      // run: the code of the last change boundary before q + k
      if (fall[k] && run >= 0 && (run & 1)) orow[((run >> 1) + 1 + q + k) >> 1] = 1;
      run = code[k] > run ? code[k] : run;
    }
    carry = total > carry ? total : carry;
  }
}

// the row's sample j, from shared memory or device memory
template <bool kShared>
__device__ __forceinline__ float sample(const float* row, int j) {
  if (kShared) return row[j];
  return __ldg(row + j);
}

// minimum and maximum that propagate NaN; a tie keeps a
__device__ __forceinline__ float nan_min(float a, float b) { return (b != b || b < a) ? b : a; }
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a) ? a : ((b != b || b > a) ? b : a);
}

// K12 lane route: two lanes a row, one for each side, 16 rows a warp.
// Position f of row r has one record in shared memory, rec[f * 16 + r],
// so the two lanes of a row and the rows of a warp never meet in a bank:
// {x, the left base, the right base, bytes: L + 1, R, the mask}.  The
// samples come straight into the records and the mask as the aligned
// words that hold its bytes, all by cp.async in one round trip.  The left
// lane settles positions from the left, the right lane from the right, in
// one loop with no branch and one load a step: where x[i] is not NaN and
// the chain's top j is not strictly higher, the step merges j's base and
// loads the record j points to (its sample, base and pointer in one
// 16-byte load); otherwise it settles i and loads the sample after the
// next position.  Every step writes i's base and pointer, final once i
// settles; two records past each end let every load go unchecked.  So no
// lane waits for another's longer chain, and the two sides run side by
// side.  Then the warp writes x - nan_max(left, right) at the peaks, +0.0
// elsewhere.
template <bool kCols>
__global__ void __launch_bounds__(32)
prominence_lane(const float* __restrict__ x, const uint8_t* __restrict__ is_peak,
                float* __restrict__ out, long long rows, int n, long long T) {
  extern __shared__ float4 records[];
  float4* rec = records + 2 * kLaneRows12;  // positions -2 .. n + 1
  uint32_t* words = reinterpret_cast<uint32_t*>(rec + kLaneRows12 * (n + 2));  // the mask's words
  const int lane = threadIdx.x, r = lane & 15, side = lane >> 4;  // side 1: the right
  const Tile t = tile_of(blockIdx.x, rows, n, T, 0, kLaneRows12);  // base: row 0, position 0
  // in columns five words a position cover its 16 bytes wherever they
  // start; in rows the tile's bytes are contiguous
  auto mask_at = [&](int f) {
    return reinterpret_cast<uintptr_t>(is_peak + t.base + (kCols ? (long long)f * T : 0));
  };
  if (kCols) {
    if (r < t.cnt) {
      for (int f = side; f < n; f += 2)
        cp_async4(&rec[f * kLaneRows12 + r].x, x + t.base + r + (long long)f * T);
    }
    for (int e = lane; e < 5 * n; e += 32) {
      const int f = e / 5;
      const uintptr_t a = mask_at(f), w = (a & ~(uintptr_t)3) + 4 * (e - 5 * f);
      if (w < a + t.cnt) cp_async4(&words[e], reinterpret_cast<const void*>(w));
    }
  } else {
    const int total = t.cnt * n;
    for (int e = lane; e < total; e += 32) {
      const int q = e / n;
      cp_async4(&rec[(e - q * n) * kLaneRows12 + q].x, x + t.base + e);
    }
    const uintptr_t a = mask_at(0), w0 = a & ~(uintptr_t)3;
    for (int k = lane; w0 + 4 * k < a + total; k += 32)
      cp_async4(&words[k], reinterpret_cast<const void*>(w0 + 4 * k));
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncwarp();
  const uint8_t* bytes = reinterpret_cast<const uint8_t*>(words);
  for (int e = lane; e < kLaneRows12 * n; e += 32) {  // each record's mask byte
    const int f = e >> 4, q = e & 15;
    if (q < t.cnt) {
      reinterpret_cast<uint8_t*>(&rec[e].w)[2] =
          kCols ? bytes[20 * f + (mask_at(f) & 3) + q] : bytes[(mask_at(0) & 3) + q * n + f];
    }
  }
  __syncwarp();
  if (r < t.cnt) {
    // the side's direction, its end and the pointer meaning none (records
    // at -2, -1, n and n + 1 are read and never used), the offset of the
    // side's byte code, L + 1 or R
    const int dir = side ? -1 : 1, end = side ? -1 : n, none = side ? n : -1, off = side ? 0 : 1;
    const float4* row = rec + r;                  // position f at row[f * 16]
    float* own = &rec[r].y + side;                // the side's base of position 0
    uint8_t* code = reinterpret_cast<uint8_t*>(&rec[r].w) + side;  // its pointer byte
    int i = side ? n - 1 : 0, j = none, lj = none;
    float xi = row[i * kLaneRows12].x, cur = xi, xj = 0.f, bj = 0.f;
    float xn = row[(i + dir) * kLaneRows12].x;
    while (i != end) {
      const bool pass = j != none && xi == xi && !(xj > xi);
      // i's base and pointer, final where it settles now, else rewritten when it does
      own[i * (kLaneRows12 * 4)] = cur;
      code[i * (kLaneRows12 * 16)] = (uint8_t)(j + off);
      // one load: the record j points to, or the sample after the next position
      const int next = i + dir;
      const float4 e = row[(pass ? lj : next + dir) * kLaneRows12];
      const float eb = side ? e.z : e.y;
      const int ep = (int)__byte_perm(__float_as_uint(e.w), 0u, 0x4440u + side) - off;
      const float merged = nan_min(cur, bj);
      const int jn = pass ? lj : i;
      lj = pass ? ep : j;
      j = jn;
      bj = pass ? eb : cur;
      xj = pass ? e.x : xi;
      cur = pass ? merged : xn;
      xi = pass ? xi : xn;
      xn = pass ? xn : e.x;
      i = pass ? i : next;
    }
  }
  __syncwarp();
  auto prominence = [&](int q, int f) {
    const float4 e = rec[f * kLaneRows12 + q];
    const bool pk = reinterpret_cast<const uint8_t*>(&e.w)[2] != 0;
    return pk ? __fsub_rn(e.x, nan_max(e.y, e.z)) : 0.f;
  };
  if (kCols) {
    if (r < t.cnt) {
      for (int f = side; f < n; f += 2) out[t.base + r + (long long)f * T] = prominence(r, f);
    }
  } else {
    store_rows(out + t.base, t.cnt, n, lane, prominence);
  }
}

// K12/K13: a warp's peaks queued 32 at a time (a ballot a chunk of 32
// positions, ranks by popcount), value(p) at each, +0.0 elsewhere
template <class Value>
__device__ __forceinline__ void for_each_peak(const uint8_t* pr, float* orow, int n, int lane,
                                              int* qw, Value value) {
  const unsigned lt = (1u << lane) - 1u;
  int fill = 0;
  for (int base = 0; base < n; base += 32) {
    const int p = base + lane;
    const bool pk = p < n && pr[p] != 0;
    if (p < n && !pk) orow[p] = 0.f;
    const unsigned b = __ballot_sync(kFull, pk);
    if (pk) qw[fill + __popc(b & lt)] = p;
    fill += __popc(b);
    __syncwarp();
    if (fill >= 32) {
      const int mine = qw[lane], rest = fill - 32;
      const int moved = lane < rest ? qw[32 + lane] : 0;
      __syncwarp();
      if (lane < rest) qw[lane] = moved;
      fill = rest;
      orow[mine] = value(mine);
      __syncwarp();
    }
  }
  if (lane < fill) {
    const int mine = qw[lane];
    orow[mine] = value(mine);
  }
}

// K12 table route: levels 1..K of maxima and minima over [i, i + 2^k)
__host__ __device__ inline int table_levels(int n) {
  int k = 0;
  while ((2 << k) <= n) ++k;
  return k;
}

__global__ void __launch_bounds__(kWarps * 32)
prominence_table(const float* __restrict__ x, const uint8_t* __restrict__ is_peak,
                 float* __restrict__ out, long long rows, int n) {
  extern __shared__ float tables[];
  __shared__ int queue[kWarps][kQueue];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, K = table_levels(n);
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= rows) return;  // whole warps: nothing below waits on the block
  float* X = tables + (size_t)warp * n * (1 + 2 * K);
  float* Mx = X + n;      // level k at Mx + (k - 1) n
  float* Mn = Mx + K * n;
  const float* xg = x + (size_t)row * n;
  for (int i = lane; i < n; i += 32) X[i] = xg[i];
  __syncwarp();
  for (int k = 1; k <= K; ++k) {
    const float* px = k == 1 ? X : Mx + (k - 2) * n;
    const float* pn = k == 1 ? X : Mn + (k - 2) * n;
    float* qx = Mx + (k - 1) * n;
    float* qn = Mn + (k - 1) * n;
    const int h = 1 << (k - 1), len = n - (1 << k) + 1;
    for (int i = lane; i < len; i += 32) {
      qx[i] = fmaxf(px[i], px[i + h]);
      qn[i] = nan_min(pn[i], pn[i + h]);
    }
    __syncwarp();
  }
  auto mx = [&](int k, int i) { return k == 0 ? X[i] : Mx[(k - 1) * n + i]; };
  auto range_min = [&](int a, int b) {  // [a, b]
    const int k = 31 - __clz(b - a + 1);
    if (k == 0) return X[a];
    const float* m = Mn + (k - 1) * n;
    return nan_min(m[a], m[b - (1 << k) + 1]);
  };
  auto prominence = [&](int p) {
    const float xp = X[p];
    int a = p, e = p;  // [a, p) and (p, e] hold nothing strictly higher
    for (int k = K; k >= 0; --k) {
      const int s = 1 << k;
      if (a - s >= 0 && !(mx(k, a - s) > xp)) a -= s;
      if (e + s <= n - 1 && !(mx(k, e + 1) > xp)) e += s;
    }
    return __fsub_rn(xp, nan_max(range_min(a, p), range_min(p, e)));
  };
  for_each_peak(is_peak + (size_t)row * n, out + (size_t)row * n, n, lane, queue[warp],
                prominence);
}

struct Prominence {
  template <bool kShared>
  __device__ __forceinline__ float operator()(const float* xr, long long, int n, int p) const {
    const float xp = sample<kShared>(xr, p);
    float lb = xp, rb = xp;
    for (int j = p - 1; j >= 0; --j) {
      const float v = sample<kShared>(xr, j);
      if (v > xp) break;
      lb = nan_min(lb, v);
    }
    for (int j = p + 1; j < n; ++j) {
      const float v = sample<kShared>(xr, j);
      if (v > xp) break;
      rb = nan_min(rb, v);
    }
    return __fsub_rn(xp, nan_max(lb, rb));
  }
};

// K13's width of the peak at p of a row whose sample j is get(j), at
// height h: the last j < p and the first j > p with x[j] <= h, both sides
// walked together, each crossing interpolated; the plain version's
// operations in its order
template <class Get>
__device__ __forceinline__ float width_of(Get get, int n, int p, float h) {
  int il = p - 1, ir = p + 1;  // end at the crossing samples, else at -1 and n
  bool left = il >= 0, right = ir < n;  // the sides still walking
  while (left || right) {
    if (left) {
      if (get(il) <= h) left = false;
      else left = --il >= 0;
    }
    if (right) {
      if (get(ir) <= h) right = false;
      else right = ++ir < n;
    }
  }
  float lx = 0.f, rx = (float)(n - 1);
  if (il >= 0) {
    const float a = __fadd_rn(get(il), 0.f);
    const float b = __fadd_rn(get(min(il + 1, n - 1)), 0.f);
    const float t = a < h ? __fdiv_rn(__fsub_rn(h, a), b != a ? __fsub_rn(b, a) : 1.f) : 0.f;
    lx = __fadd_rn((float)il, t);
  }
  if (ir < n) {
    const float a = __fadd_rn(get(ir), 0.f);
    const float b = __fadd_rn(get(max(ir - 1, 0)), 0.f);
    const float t = a < h ? __fdiv_rn(__fsub_rn(h, a), b != a ? __fsub_rn(b, a) : 1.f) : 0.f;
    rx = __fsub_rn((float)ir, t);
  }
  return __fsub_rn(rx, lx);
}

// K13's height at a peak: the product rounded, then the difference
__device__ __forceinline__ float width_height(float xp, float rel, float prom) {
  return __fsub_rn(xp, __fmul_rn(rel, prom));
}

struct Width {
  const float* prom;  // (rows, n), row-major
  float rel;
  template <bool kShared>
  __device__ __forceinline__ float operator()(const float* xr, long long row, int n,
                                              int p) const {
    const float h = width_height(sample<kShared>(xr, p), rel, __ldg(prom + (size_t)row * n + p));
    return width_of([&](int j) { return sample<kShared>(xr, j); }, n, p, h);
  }
};

// K13 lane route on rows as columns: persistent warps, each taking tiles
// of 32 neighbouring rows (tile_of) gridDim.x apart, two in shared memory
// at once: the next tile is copied in while the lanes walk this one.  A
// tile's mask comes by cp.async as the aligned words that hold its bytes
// (nine a position cover its 32 bytes wherever they start), its x into
// xs[f * 33 + r] (33 floats a position, so lanes on one row meet in no
// bank).  Each lane reads its row's mask into bits in registers and writes
// +0.0 over its row (whole lines across the warp, the widths landing on
// the peaks later: zeros off the peaks alone leave partial lines, which
// cost more), a scan of the rows' counts across the lanes places the
// peaks in the tile's list in the mask's words, free by then: f * 32 + r,
// its prominence copied in by cp.async beside it (a chunk at a time where
// the list outgrows the words).  Then the lanes take the list 32 at a
// time, each walking its peak's two sides in shared memory and writing
// the width.  No step waits on another lane but the scan and a chunk.
__global__ void __launch_bounds__(32)
width_lane(const float* __restrict__ x, const uint8_t* __restrict__ is_peak,
           const float* __restrict__ prom, float* __restrict__ out, long long rows, int n,
           long long T, float rel, long long tiles) {
  extern __shared__ float lane13[];
  const int lane = threadIdx.x;
  const int per = (kPitch13 + 9) * n;  // floats a buffer: x, then the mask's words
  const int cap = 6 * n;               // the list in the words: cap prominences, cap codes
  // the offset of row q's position f from a tile's base
  auto at = [&](int q, int f) { return q + (long long)f * T; };
  // one tile's mask and x into buffer buf, one cp.async group
  auto stage = [&](long long g, float* buf) {
    const Tile t = tile_of(g, rows, n, T, 0);
    uint32_t* words = reinterpret_cast<uint32_t*>(buf + kPitch13 * n);
    const uintptr_t a0 = reinterpret_cast<uintptr_t>(is_peak + t.base);
    for (int e = lane; e < 9 * n; e += 32) {
      const int f = e / 9;
      const uintptr_t a = a0 + f * T, w = (a & ~(uintptr_t)3) + 4 * (e - 9 * f);
      if (w < a + t.cnt) cp_async4(&words[e], reinterpret_cast<const void*>(w));
    }
    if (lane < t.cnt) {
      for (int f = 0; f < n; ++f) cp_async4(&buf[f * kPitch13 + lane], x + t.base + at(lane, f));
    }
    cp_async_commit();
  };
  long long g = blockIdx.x;
  if (g >= tiles) return;
  stage(g, lane13);
  for (int i = 0; g < tiles; ++i, g += gridDim.x) {
    float* xs = lane13 + (i & 1) * per;  // x of row r at position f: xs[f * kPitch13 + r]
    float* plist = xs + kPitch13 * n;    // the mask's words, then the list
    uint16_t* list = reinterpret_cast<uint16_t*>(plist + cap);
    const Tile t = tile_of(g, rows, n, T, 0);
    const long long next = g + gridDim.x;
    cp_async_wait<0>();  // this tile's mask and x
    __syncwarp();
    const uint8_t* bytes = reinterpret_cast<const uint8_t*>(plist);
    // a position's first byte in its words
    const int lo = (int)(reinterpret_cast<uintptr_t>(is_peak + t.base) & 3), step = (int)(T & 3);
    uint32_t bits[kLaneMax13 / 32];  // the row's peaks
    int mine = 0;
#pragma unroll
    for (int w = 0; w < kLaneMax13 / 32; ++w) {
      bits[w] = 0;
      if (lane < t.cnt) {
        for (int f = w * 32; f < min(n, w * 32 + 32); ++f) {
          const bool pk = bytes[36 * f + ((lo + f * step) & 3) + lane] != 0;
          bits[w] |= (uint32_t)pk << (f - w * 32);
          out[t.base + at(lane, f)] = 0.f;
        }
      }
      mine += __popc(bits[w]);
    }
    int incl = mine;  // an inclusive scan of the rows' counts
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += v;
    }
    const int total = __shfl_sync(kFull, incl, 31), first = incl - mine;
    __syncwarp();  // every mask byte read, and the zeros written, before the list and widths
    if (total == 0 && next < tiles) stage(next, lane13 + ((i + 1) & 1) * per);
    for (int c0 = 0; c0 < total; c0 += cap) {
      const int c1 = min(total, c0 + cap);
      if (first < c1 && first + mine > c0) {  // this row's peaks with places in [c0, c1)
        int k = first;
#pragma unroll
        for (int w = 0; w < kLaneMax13 / 32; ++w) {
          for (uint32_t b = bits[w]; b; b &= b - 1, ++k) {
            if (k >= c0 && k < c1) {
              const int f = w * 32 + __ffs(b) - 1;
              list[k - c0] = (uint16_t)(f * 32 + lane);
              cp_async4(&plist[k - c0], prom + t.base + at(lane, f));
            }
          }
        }
      }
      cp_async_commit();
      if (c0 == 0 && next < tiles) {  // the next tile lands while this one is walked
        stage(next, lane13 + ((i + 1) & 1) * per);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncwarp();
      for (int k = c0 + lane; k < c1; k += 32) {
        const int code = list[k - c0], p = code >> 5, r = code & 31;
        const float* xr = xs + r;
        const float h = width_height(xr[p * kPitch13], rel, plist[k - c0]);
        out[t.base + at(r, p)] = width_of([&](int j) { return xr[j * kPitch13]; }, n, p, h);
      }
      __syncwarp();  // the chunk read before the next one overwrites it
    }
  }
  cp_async_wait<0>();
}

// K12's walk route and K13: a warp a row; +0.0 off the peaks, op(row, p) at each peak
template <bool kShared, class Op>
__global__ void __launch_bounds__(kWarps * 32)
peak_walk_kernel(const float* __restrict__ x, const uint8_t* __restrict__ is_peak,
                 float* __restrict__ out, long long rows, int n, Op op) {
  extern __shared__ float staged[];
  __shared__ int queue[kWarps][kQueue];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row = (long long)blockIdx.x * kWarps + warp;
  if (row >= rows) return;  // whole warps: nothing below waits on the block
  const float* xg = x + (size_t)row * n;
  const float* xr = xg;
  if (kShared) {
    float* s = staged + (size_t)warp * n;
    for (int i = lane; i < n; i += 32) s[i] = xg[i];
    xr = s;
    __syncwarp();
  }
  for_each_peak(is_peak + (size_t)row * n, out + (size_t)row * n, n, lane, queue[warp],
                [&](int p) { return op.template operator()<kShared>(xr, row, n, p); });
}

// the walks, each row staged in shared memory (kShared, n <= kSharedMax)
// or read from device memory
template <bool kShared, class Op>
int launch_walk(const float* x, const uint8_t* is_peak, float* out, long long rows, int n, Op op,
                void* stream) {
  if (rows <= 0 || n <= 0 || (kShared && n > kSharedMax)) return (int)cudaErrorInvalidValue;
  const long long blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = kShared ? (size_t)kWarps * n * sizeof(float) : 0;
  peak_walk_kernel<kShared, Op><<<(unsigned)blocks, kWarps * 32, smem, (cudaStream_t)stream>>>(
      x, is_peak, out, rows, n, op);
  return (int)cudaGetLastError();
}

// a lane route's warp tiles: `per` rows each, in columns per b
bool lane_tiles(long long rows, long long T, int per, long long* tiles) {
  if (T > 0) {
    if (rows % T != 0) return false;
    *tiles = rows / T * ((T + per - 1) / per);
  } else {
    *tiles = (rows + per - 1) / per;
  }
  return *tiles <= 0x7fffffffLL;
}

}  // namespace

// K11: out (rows, n) bytes, 1 at the local maxima of x (rows, n), n >= 3,
// in x's layout; route 0 a lane a row (rows as columns, T > 0, n <=
// kLaneMax11), 1 a warp a row (contiguous rows, T = 0)
extern "C" int apt_local_maxima(const float* x, uint8_t* out, long long rows, long long n,
                                long long T, int route, void* stream) {
  if (rows <= 0 || n < 3 || T < 0 || (T > 0) != (route == 0)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (route == 0) {
    long long tiles = 0;
    if (n > kLaneMax11 || !lane_tiles(rows, T, 32, &tiles)) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)32 * n * sizeof(float);
    const cudaError_t err = allow_smem(local_maxima_lane_cols, smem);
    if (err != cudaSuccess) return (int)err;
    local_maxima_lane_cols<<<(unsigned)tiles, 32, smem, s>>>(x, out, T, (int)n);
    return (int)cudaGetLastError();
  }
  if (route != 1) return (int)cudaErrorInvalidValue;
  const long long blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (n < (1LL << 30)) {
    local_maxima_kernel<int><<<(unsigned)blocks, kWarps * 32, 0, s>>>(x, out, rows, (int)n);
  } else {
    local_maxima_kernel<long long><<<(unsigned)blocks, kWarps * 32, 0, s>>>(x, out, rows, n);
  }
  return (int)cudaGetLastError();
}

// K12: out (rows, n), the prominence at each peak of is_peak (bytes), +0.0
// elsewhere, all three in one layout (T > 0 rows as columns, the lane
// route only); route 0 two lanes a row (n <= kLaneMax12), 1 the range
// tables (n <= kSharedMax), 2 the walks
extern "C" int apt_peak_prominences(const float* x, const uint8_t* is_peak, float* out,
                                    long long rows, int n, long long T, int route,
                                    void* stream) {
  if (rows <= 0 || n <= 0 || T < 0 || (T > 0 && route != 0)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (route == 0) {
    long long tiles = 0;
    if (n > kLaneMax12 || !lane_tiles(rows, T, kLaneRows12, &tiles))
      return (int)cudaErrorInvalidValue;
    // the records of positions -2 .. n + 1, then the mask's words (five a
    // position, or the tile's bytes and two); each kernel allowed the most
    // any row takes, so that no call lowers it under another's launch
    auto smem_of = [](int m) {
      return (size_t)kLaneRows12 * (m + 4) * sizeof(float4) + 20 * m + 8;
    };
    const size_t smem = smem_of(n);
    cudaError_t err;
    if (T > 0) {
      err = allow_smem(prominence_lane<true>, smem_of(kLaneMax12));
      if (err == cudaSuccess)
        prominence_lane<true><<<(unsigned)tiles, 32, smem, s>>>(x, is_peak, out, rows, n, T);
    } else {
      err = allow_smem(prominence_lane<false>, smem_of(kLaneMax12));
      if (err == cudaSuccess)
        prominence_lane<false><<<(unsigned)tiles, 32, smem, s>>>(x, is_peak, out, rows, n, 0);
    }
    return (int)(err != cudaSuccess ? err : cudaGetLastError());
  }
  if (route == 1) {
    if (n > kSharedMax) return (int)cudaErrorInvalidValue;
    const size_t per_warp = (size_t)n * (1 + 2 * table_levels(n)) * sizeof(float);
    const long long warps = per_warp * kWarps <= kTableSmem ? kWarps
                            : per_warp * 2 <= kTableSmem    ? 2
                                                            : 1;
    const long long blocks = (rows + warps - 1) / warps;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const size_t smem = per_warp * warps;
    const cudaError_t err = allow_smem(prominence_table, smem);
    if (err != cudaSuccess) return (int)err;
    prominence_table<<<(unsigned)blocks, (unsigned)(warps * 32), smem, s>>>(x, is_peak, out,
                                                                           rows, n);
    return (int)cudaGetLastError();
  }
  if (route != 2) return (int)cudaErrorInvalidValue;
  return n <= kSharedMax ? launch_walk<true>(x, is_peak, out, rows, n, Prominence{}, stream)
                         : launch_walk<false>(x, is_peak, out, rows, n, Prominence{}, stream);
}

// K13: out (rows, n), the width at rel_height of each peak of is_peak
// (bytes), +0.0 elsewhere, all four in one layout; route 0 a lane a peak
// of a warp's tile of 32 rows (rows as columns, T > 0, n <= kLaneMax13), 1
// the walks from device memory (contiguous rows, T = 0)
extern "C" int apt_peak_widths_rel(const float* x, const uint8_t* is_peak, const float* prom,
                                   float* out, long long rows, int n, long long T,
                                   float rel_height, int route, void* stream) {
  if (rows <= 0 || n <= 0 || T < 0 || (T > 0) != (route == 0)) return (int)cudaErrorInvalidValue;
  if (route == 0) {
    long long tiles = 0;
    if (n > kLaneMax13 || !lane_tiles(rows, T, 32, &tiles)) return (int)cudaErrorInvalidValue;
    // two buffers, each x at 33 floats a position and the mask's words
    // (nine a position), which then hold the list of peaks
    auto smem_of = [](int m) { return 2 * (size_t)(kPitch13 + 9) * m * sizeof(float); };
    const size_t smem = smem_of(n);
    // the most any row takes, so that no call lowers it under another's
    // launch; and more of the SM's unified memory left to L1, which holds
    // the lines cp.async copies through: 7 warps an SM at the gate's rows,
    // not 9
    cudaError_t err = allow_smem(width_lane, smem_of(kLaneMax13));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(width_lane, cudaFuncAttributePreferredSharedMemoryCarveout, 75);
    int device = 0, sms = 0, per_sm = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, width_lane, 32, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm == 0) return (int)cudaErrorInvalidConfiguration;
    const long long warps = (long long)sms * per_sm;  // persistent: the card full once
    width_lane<<<(unsigned)(tiles < warps ? tiles : warps), 32, smem, (cudaStream_t)stream>>>(
        x, is_peak, prom, out, rows, n, T, rel_height, tiles);
    return (int)cudaGetLastError();
  }
  if (route != 1) return (int)cudaErrorInvalidValue;
  return launch_walk<false>(x, is_peak, out, rows, n, Width{prom, rel_height}, stream);
}
