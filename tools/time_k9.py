#!/usr/bin/env python3
"""Device time of K9 (the stage-2 confirmer's distance filter over peaks,
``csrc/peaks.cu``) at the confirmer's shape and at rows that stress it.

    python3 tools/time_k9.py [--root DIR] [--out FILE] [--cases] [--variant NAME ...]

Cases: the confirmer's rows, captured from ``chip_smoke.py``'s clip 1 (871
windows x 384, d = 45) at cap 64 and at cap 5,000; the same rows with
non-finite and signed-zero peaks (``chip_smoke.with_nonfinite_peaks``) at
cap 64; 871 rows of 1,024 uniform-noise positions (about 340 local maxima
a row) at cap 64 and at cap 5,000.

For each: the mask against the plain loop bit for bit, else it exits
non-zero; then device ms per launch from a CUDA graph of 20 back-to-back
launches (``chip_smoke.graph_ms``) and ms per host-launched call (CUDA
events, median of 20); the plain loop's ms on the confirmer's rows.
``--cases`` first holds the kernel to the plain loop on every case of
``chip_smoke.py``'s phase 26.  ``--variant`` also times named edits of the
committed kernel (``VARIANTS``, built from a copy of ``csrc/`` under
``build/k9_variants/``): the design choices tried, and timing-only cuts
that drop a phase.  ``--root`` imports the port from another checkout
(the parent's kernels: ``git archive <parent> | tar -x -C build/parent``),
so that two trees are compared on one card, one process each; the cases
and the timing helpers always come from this checkout's
``chip_smoke.py``.  Prints the card's name and power limit, then one JSON
line.  Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import shutil
import sys
from pathlib import Path

from time_k6_k7 import sm_clock_under, smi_query

REPO = Path(__file__).resolve().parent.parent

#: the walk of the committed kernel: each candidate read from shared memory in turn
WALK = """#pragma unroll 4
  for (int k = 0; k < candidates; ++k) {
    const int p = cand[k];
    const unsigned win = window_bits(p, d, lane);
    if (!((__shfl_sync(kFull, covered, p >> 5) >> (p & 31)) & 1u)) covered |= win;
  }"""
#: the candidates brought to the lanes 32 at a time and shuffled from there
LANE_WALK = """  for (int c0 = 0; c0 < candidates; c0 += 32) {
    const int m = min(32, candidates - c0);
    const int mine = lane < m ? cand[c0 + lane] : 0;
#pragma unroll 4
    for (int j = 0; j < m; ++j) {
      const int p = __shfl_sync(kFull, mine, j);
      const unsigned win = window_bits(p, d, lane), bit = 1u << (p & 31);
      if (!(__shfl_sync(kFull, covered, p >> 5) & bit)) covered |= win;
    }
  }"""
#: a walk whose chain is integer operations only: candidate j of a chunk
#: (lane j) is open if no kept candidate of an earlier chunk covers it, and
#: conflicts with the chunk's earlier candidates within d; then, in order,
#: it is kept if open and clear of every kept one before it
CONFLICT_WALK = """  for (int c0 = 0; c0 < candidates; c0 += 32) {
    const int m = min(32, candidates - c0);
    const int p = lane < m ? cand[c0 + lane] : 0;
    const unsigned cw = __shfl_sync(kFull, covered, p >> 5);
    const unsigned open = __ballot_sync(kFull, lane < m && !((cw >> (p & 31)) & 1u));
    unsigned conflicts = 0u;
#pragma unroll 4
    for (int i = 0; i < m; ++i) {
      const int q = __shfl_sync(kFull, p, i);
      conflicts |= (i < lane && abs(q - p) < d ? 1u : 0u) << i;
    }
    unsigned kept = 0u;
#pragma unroll 8
    for (int i = 0; i < m; ++i) {
      const unsigned ci = __shfl_sync(kFull, conflicts, i);
      if (((open >> i) & 1u) && !(ci & kept)) kept |= 1u << i;
    }
    for (unsigned rest = kept; rest; rest &= rest - 1u) {
      covered |= window_bits(__shfl_sync(kFull, p, __ffs(rest) - 1), d, lane);
    }
  }"""
NO_SELECT = ("if (steps < P && P > 32 * kRankSlots) {", "if (false) {")
#: the committed loads and stores, a scalar access a position
LOADS = """  // 1. loads
  float v[kGroups][4];
  unsigned nib[kGroups];  // bit j: position 128 c + 4 lane + j is a peak
#pragma unroll
  for (int c = 0; c < kGroups; ++c) {
    const int q = 128 * c + 4 * lane;
    nib[c] = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[c][j] = 0.f;
      if (c < groups && q + j < n) {
        v[c][j] = xr[q + j];
        nib[c] |= (pr[q + j] != 0 ? 1u : 0u) << j;
      }
    }
  }"""
STORES = """  // 5. stores: is_peak & ~covered
#pragma unroll
  for (int c = 0; c < kGroups; ++c) {
    if (c < groups) {
      const unsigned cw = __shfl_sync(kFull, covered, 4 * c + (lane >> 3));
      const unsigned keep = nib[c] & ~(cw >> (4 * (lane & 7))) & 0xfu;
      const int q = 128 * c + 4 * lane;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (q + j < n) orow[q + j] = (uint8_t)((keep >> j) & 1u);
      }
    }
  }
}"""
#: 16-byte loads of x, 4-byte loads of is_peak and 4-byte stores of the mask
#: where a row is aligned, scalar elsewhere
VECTOR_LOADS = """  // 1. loads
  const bool vec_in = ((uintptr_t)xr & 15) == 0 && ((uintptr_t)pr & 3) == 0;
  float v[kGroups][4];
  unsigned nib[kGroups];  // bit j: position 128 c + 4 lane + j is a peak
#pragma unroll
  for (int c = 0; c < kGroups; ++c) {
    const int q = 128 * c + 4 * lane;
    nib[c] = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j) v[c][j] = 0.f;
    if (c < groups) {
      if (vec_in && q + 3 < n) {
        const float4 f = *reinterpret_cast<const float4*>(xr + q);
        const uint32_t b = *reinterpret_cast<const uint32_t*>(pr + q);
        v[c][0] = f.x;
        v[c][1] = f.y;
        v[c][2] = f.z;
        v[c][3] = f.w;
        nib[c] = (b & 0xffu ? 1u : 0u) | (b & 0xff00u ? 2u : 0u) | (b & 0xff0000u ? 4u : 0u) |
                 (b & 0xff000000u ? 8u : 0u);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (q + j < n) {
            v[c][j] = xr[q + j];
            nib[c] |= (pr[q + j] != 0 ? 1u : 0u) << j;
          }
        }
      }
    }
  }"""
VECTOR_STORES = """  // 5. stores: is_peak & ~covered
  const bool vec_out = ((uintptr_t)orow & 3) == 0;
#pragma unroll
  for (int c = 0; c < kGroups; ++c) {
    if (c < groups) {
      const unsigned cw = __shfl_sync(kFull, covered, 4 * c + (lane >> 3));
      const unsigned keep = nib[c] & ~(cw >> (4 * (lane & 7))) & 0xfu;
      const int q = 128 * c + 4 * lane;
      if (vec_out && q + 3 < n) {
        *reinterpret_cast<uint32_t*>(orow + q) = (keep & 1u) | ((keep >> 1) & 1u) << 8 |
                                                 ((keep >> 2) & 1u) << 16 | (keep >> 3) << 24;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (q + j < n) orow[q + j] = (uint8_t)((keep >> j) & 1u);
        }
      }
    }
  }
}"""

#: name: (keeps the plain loop's bits, [(text, replacement)] in peaks.cu)
VARIANTS = {
    # two or eight rows (warps) a block
    **{f"warps-{n}": (True, [("constexpr int kWarps = 4;", f"constexpr int kWarps = {n};")])
       for n in (2, 8)},
    # 16-byte loads and 4-byte stores where a row is aligned
    "vector-loads": (True, [(LOADS, VECTOR_LOADS), (STORES, VECTOR_STORES)]),
    # one or four slots a lane ranks in one pass over the keys
    **{f"rank-slots-{n}": (True, [("constexpr int kRankSlots = 2;",
                                   f"constexpr int kRankSlots = {n};")]) for n in (1, 4)},
    # every peak ranked, no top-`steps` selection
    "no-select": (True, [NO_SELECT]),
    # the walk with its candidates in the lanes, or with conflict masks
    "lane-walk": (True, [(WALK, LANE_WALK)]),
    "conflict-walk": (True, [(WALK, CONFLICT_WALK)]),
    # rank counting one key at a time (the compiler's unrolling) instead of
    # batches of eight loads
    "rank-unbatched": (True, [("constexpr int kBatch = 8;", "constexpr int kBatch = 1;")]),
    # timing only: without the walk, or without the ranks (and so the walk)
    "no-walk": (False, [(WALK, WALK.replace("k < candidates", "k < 0"))]),
    "no-rank": (False, [("for (int s0 = 0; s0 < ranked; s0 += 32 * kRankSlots)",
                         "for (int s0 = 0; s0 < 0; s0 += 32 * kRankSlots)")]),
}


def load_chip_smoke():
    """This checkout's ``chip_smoke.py`` as the module ``chip_smoke``,
    whatever ``--root`` puts first on the path."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = mod
    spec.loader.exec_module(mod)
    return mod


def cases(dev) -> dict:
    """K9's ``(x, is_peak, distance, max_peaks)`` by label."""
    import numpy as np
    import torch

    import chip_smoke
    from audio_processing_tools_tpu_torch.ops import peaks as tpk

    clips, _ = chip_smoke.synth_clips()
    pcm = (clips[1] * 32767.0).astype(np.int16)  # phase 4's clip 1, as MARK files hold it
    env, is_max, dist = chip_smoke.k9_confirmer_rows(pcm.astype(np.float32) / np.float32(32767.0),
                                                     dev)
    odd = torch.from_numpy(chip_smoke.with_nonfinite_peaks(env.cpu().numpy(),
                                                           is_max.cpu().numpy(), 9)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(9)
    noise = torch.rand((env.shape[0], 1024), generator=gen, device=dev)
    noise_pk = tpk.local_maxima(noise)
    R, n = env.shape
    return {f"the confirmer's {R} x {n}, d {dist}, cap 64": (env, is_max, dist, 64),
            f"the confirmer's {R} x {n}, d {dist}, cap 5,000": (env, is_max, dist, 5000),
            f"the confirmer's {R} x {n}, non-finite peaks, cap 64": (odd, is_max, dist, 64),
            f"noise {R} x 1,024, d {dist}, cap 64": (noise, noise_pk, dist, 64),
            f"noise {R} x 1,024, d {dist}, cap 5,000": (noise, noise_pk, dist, 5000)}


def check_phase26(tpk, dev) -> int:
    """K9 against the plain loop on every case of ``chip_smoke.py``'s phase
    26 that needs no clip; exits non-zero on the first that differs."""
    import torch

    import chip_smoke

    n_ok = 0
    for label, x, pk, d, cap in chip_smoke.k9_edge_cases():
        x, pk = torch.from_numpy(x).to(dev), torch.from_numpy(pk).to(dev)
        got = tpk._select_peaks_by_distance_cuda(x, pk, d, cap)
        ref = tpk._select_peaks_by_distance_plain(x, pk, d, cap)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise SystemExit(f"K9 {label}, d {d}, cap {cap}: {int((got != ref).sum())} "
                             f"positions differ from the plain loop")
        n_ok += 1
    return n_ok


def time_k9(tpk, table: dict, exact: bool = True) -> dict:
    import numpy as np
    import torch

    import chip_smoke

    out = {}
    for label, (x, pk, d, cap) in table.items():
        got = tpk._select_peaks_by_distance_cuda(x, pk, d, cap)
        ref = tpk._select_peaks_by_distance_plain(x, pk, d, cap)
        torch.cuda.synchronize()
        same = torch.equal(got, ref)
        if exact and not same:
            raise SystemExit(f"K9 {label}: {int((got != ref).sum())} positions differ from the "
                             f"plain loop")
        fn = lambda: tpk._select_peaks_by_distance_cuda(x, pk, d, cap)  # noqa: E731
        peaks = pk.sum(-1)
        out[label] = {"same_bits": same, "peaks_per_row": [int(peaks.min()), int(peaks.median()),
                                                           int(peaks.max())],
                      "kept": int(got.sum()), "graph_ms": chip_smoke.graph_ms(fn),
                      "call_ms": float(np.median(chip_smoke.cuda_times(fn, 20)))}
        print(f"K9 {label}: {out[label]}")
    return out


def variant_source(csrc: Path, name: str) -> Path:
    """A copy of ``csrc`` with the edits of variant ``name`` to peaks.cu."""
    out = REPO / "build" / "k9_variants" / name
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(csrc, out)
    src = (out / "peaks.cu").read_text()
    for text, replacement in VARIANTS[name][1]:
        if src.count(text) != 1:
            raise SystemExit(f"variant {name}: peaks.cu has no single {text!r}")
        src = src.replace(text, replacement)
    (out / "peaks.cu").write_text(src)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--out", default=None, help="also write the JSON line to this file")
    ap.add_argument("--cases", action="store_true",
                    help="first hold K9 to the plain loop on chip_smoke.py's phase-26 cases")
    ap.add_argument("--variant", action="append", default=[], choices=sorted(VARIANTS))
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_k9: no CUDA device", file=sys.stderr)
        return 1
    # the port from --root first: chip_smoke.py puts its own checkout first on the path
    from audio_processing_tools_tpu_torch import _kernels
    from audio_processing_tools_tpu_torch.ops import peaks as tpk

    chip_smoke = load_chip_smoke()

    smi = smi_query("name,power.limit")
    print(smi)
    lib = _kernels.build()
    keep = False  # ptxas's lines for K9's kernel
    for ln in lib.build_log.splitlines():
        if "Compiling entry function" in ln:
            keep = "select_peaks_by_distance" in ln
        if keep and "ptxas info" in ln:
            print(ln.strip())
    dev = torch.device("cuda", 0)
    result = {"root": args.root, "package": str(Path(tpk.__file__).resolve().parent.parent),
              "card": smi}
    print(f"the port from {result['package']}")
    if args.cases:
        result["phase26_cases_same_bits"] = check_phase26(tpk, dev)
        print(f"phase-26 cases, the plain loop's bits: {result['phase26_cases_same_bits']}")
    table = cases(dev)
    result["k9"] = time_k9(tpk, table)
    env, is_max, dist, _ = next(iter(table.values()))
    result["plain_ms"] = float(np.median(chip_smoke.cuda_times(
        lambda: tpk._select_peaks_by_distance_plain(env, is_max, dist, 64), 3)))
    result["sm_clock"] = sm_clock_under(
        lambda: tpk._select_peaks_by_distance_cuda(env, is_max, dist, 64))
    print(f"plain loop {result['plain_ms']:.3f} ms; SM clock under K9: {result['sm_clock']}")

    result["variants"] = {}
    csrc = _kernels.CSRC
    for name in args.variant:
        _kernels.CSRC, _kernels._LIBRARY = variant_source(csrc, name), None
        result["variants"][name] = time_k9(tpk, table, VARIANTS[name][0])
        _kernels.CSRC, _kernels._LIBRARY = csrc, None
    line = json.dumps(result)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
