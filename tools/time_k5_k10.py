#!/usr/bin/env python3
"""Device time of K5 (the suppressor's gain smoother, ``csrc/gain.cu``) and
K10 (the threshold sweep's decision counts, ``csrc/sweep.cu``) at the shapes
their paths give them, with each launch apart.

    python3 tools/time_k5_k10.py [--root DIR] [--out FILE] [--variant NAME ...]

K5: the audio-out batch's gain (128 clips x 71 band bins x 873 frames, made
by the suppressor from ``chip_smoke.py``'s 128 synthetic 10 s clips), with
random noise confidences and with the engine's own, adaptive and not.  K10:
the features of ``chip_smoke.py``'s phase-31 corpus (128 x 10 s, through
int16) with the sweep's 4,096 combos, one combo (the fit's scoring call),
the four blocks of 1,024 combos that a 4-entry mesh launches, and 4,096
combos whose every threshold is distinct.

For each: the outputs against the plain version (K5 bit for bit where values
are numbers, ``chip_smoke.same_bits``; K10 the same integers), else it exits
non-zero; then device ms per launch from a CUDA graph of 20 back-to-back
launches (``chip_smoke.graph_ms``), each CUDA kernel's device ms per launch
(``chip_smoke.launch_breakdown``), and ms per host-launched call (CUDA
events, median of 20; K10's call includes its log planes and pair tables).
The SM clock is read with ``nvidia-smi`` while K5 runs for a second.
``--variant`` also times named edits of the committed kernels
(``VARIANTS``: source edits built from a copy of ``csrc/`` under
``build/k5k10_variants/``, or the wrapper's K10 slice plan): the design
choices tried, and timing-only cuts that drop a phase.  ``--root``
imports the port and ``chip_smoke.py`` from another checkout (the parent's
kernels: ``git archive <parent> | tar -x -C build/parent``), so that two
trees are compared on one card, one process each.  Prints the card's name and power limit, then one JSON line.  Needs a
CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
from pathlib import Path

from time_k6_k7 import sm_clock_under, smi_query

REPO = Path(__file__).resolve().parent.parent

#: name: (kernel, keeps the plain version's results, [(source, text, replacement)],
#:        {ops/sweep.py constant: value})
VARIANTS = {
    # K10 slices aiming at two, or four, blocks an SM (the sweep: slices of
    # 1,024 or 512 combos)
    **{f"k10-target-blocks-{n}": ("k10", True, [], {"K10_TARGET_BLOCKS": n}) for n in (264, 528)},
    # K10 blocks aiming at 24 or 96 KB of shared memory (an all-distinct
    # grid: slices of 32 or 128 combos)
    **{f"k10-slice-bytes-{n}k": ("k10", True, [], {"K10_SLICE_BYTES": n * 1024}) for n in (24, 96)},
    # K10 with 512 threads a block
    "k10-threads-512": ("k10", True, [("sweep.cu", "constexpr int kThreads = 256;",
                                       "constexpr int kThreads = 512;")], {}),
    # K10 without its masks, or without its counts (timing only)
    "k10-no-masks": ("k10", False, [("sweep.cu", "for (; w0 < W; w0 += kWarps * kWordsPerWarp)",
                                     "for (; w0 < 0; w0 += kWarps * kWordsPerWarp)")], {}),
    "k10-no-counts": ("k10", False, [("sweep.cu", "for (int i = threadIdx.x; i < S && c0 + i < C;",
                                      "for (int i = threadIdx.x; i < 0 && c0 + i < C;")], {}),
    # K5 with K2's lane rule: the largest power of two up to 32 that still
    # gives 132 blocks (284 blocks of 32, two or three an SM)
    "k5-power-of-two-lanes": ("k5", True, [("gain.cu", """  const long long per_sm = (lanes + (long long)kMaxLanes * kTargetBlocks - 1) /
                           ((long long)kMaxLanes * kTargetBlocks);
  const long long L = (lanes + kTargetBlocks * per_sm - 1) / (kTargetBlocks * per_sm);
  return (int)(L < 1 ? 1 : L);""", """  int L = kMaxLanes;
  while (L > 1 && (lanes + L - 1) / L < kTargetBlocks) L /= 2;
  return L;""")], {}),
    # K5 with 2 or 3 tiles in its ring
    **{f"k5-stages-{n}": ("k5", True, [("gain.cu", "constexpr int kStages = 4;",
                                        f"constexpr int kStages = {n};")], {}) for n in (2, 3)},
    # K5 with tiles of 32 or 128 frames
    **{f"k5-tile-{n}": ("k5", True, [("gain.cu", "constexpr int kFrameTile = 64;",
                                      f"constexpr int kFrameTile = {n};"),
                                     ("gain.cu", "constexpr int kLgTile = 6;",
                                      f"constexpr int kLgTile = {n.bit_length() - 1};")], {})
       for n in (32, 128)},
    # K5 without the walk, or without the stores (timing only)
    "k5-no-walk": ("k5", False, [("gain.cu", "const bool walks = ld < 0 && l < nl;",
                                  "const bool walks = false;")], {}),
    # K5 without the rain frames' max, or without the alpha pass (timing only)
    "k5-no-rain-max": ("k5", False, [("gain.cu", "if (ns[u] < c.th && gt <= gft) gt = gft;",
                                      "")], {}),
    # K5 with the rain frames' max as nan_max, three compares on the chain
    "k5-nan-max-on-the-chain": ("k5", True, [("gain.cu",
                                              "if (ns[u] < c.th && gt <= gft) gt = gft;",
                                              "if (ns[u] < c.th) gt = nan_max(gt, gft);")], {}),
    "k5-no-alpha-pass": ("k5", False, [("gain.cu", "for (int i = threadIdx.x; i < nclips * kFrameTile;",
                                        "for (int i = threadIdx.x; i < 0;")], {}),
    "k5-no-store": ("k5", False, [("gain.cu", "if (j < nt) dst[j] = src[j];",
                                   "if (j < 0) dst[j] = src[j];")], {}),
}


def call_ms(fn) -> float:
    import numpy as np

    import chip_smoke

    return float(np.median(chip_smoke.cuda_times(fn, 20)))


def k5_cases(dev) -> dict:
    """K5's (G_freq, noise_conf, config) at the audio-out batch's shape."""
    import torch

    import chip_smoke
    from audio_processing_tools_tpu_torch.config import build_noise_config
    from audio_processing_tools_tpu_torch.models import spectral_noise as tsn

    clips, _ = chip_smoke.synth_clips()
    x = torch.from_numpy(clips).to(dev)
    params = chip_smoke.DEFAULT_PARAMS
    cfg = build_noise_config(chip_smoke.FS, params)
    cfg_fixed = build_noise_config(chip_smoke.FS, {**params, "adaptive_gain_enable": False})
    dbg = tsn.SpectralNoiseEngine(build_noise_config(chip_smoke.FS, {**params,
                                                                     "return_debug": True}),
                                  device=dev).process_batch(x)
    P, N = dbg["debug"]["P_band_all"], dbg["debug"]["N_band_all"]
    G = tsn.gain_freq_stage(cfg, P, torch.minimum(N, P), dbg["noise_conf"]).contiguous()
    nc_eng = torch.clamp(dbg["noise_conf"], 0.0, 1.0).contiguous()
    gen = torch.Generator(device=dev).manual_seed(7)
    nc_rand = torch.rand(nc_eng.shape, generator=gen, device=dev)
    shape = " x ".join(str(n) for n in G.shape)
    return {f"{shape}, random noise_conf, adaptive": (G, nc_rand, cfg),
            f"{shape}, the engine's noise_conf, adaptive": (G, nc_eng, cfg),
            f"{shape}, random noise_conf, not adaptive": (G, nc_rand, cfg_fixed)}


def k10_cases(dev) -> dict:
    """K10's (features, params) at the sweep's, the fit's, the mesh's and
    an all-distinct grid's shapes."""
    import numpy as np
    import torch

    import chip_smoke
    from audio_processing_tools_tpu_torch.ops import sweep
    from audio_processing_tools_tpu_torch.tuning.grid_search import (
        combo_sweep_params,
        generate_param_combinations,
        spectral_threshold_features,
    )
    from audio_processing_tools_tpu_torch.utils.corpus import (
        CLIP_CLASSES,
        HARD_CLIP_CLASSES,
        make_labeled_corpus,
    )

    counts = {**{k: 16 for k in CLIP_CLASSES}, **{k: 12 for k in HARD_CLIP_CLASSES}}
    clips, _, _ = make_labeled_corpus(seed=31, seconds=chip_smoke.CLIP_SEC, counts=counts)
    pcm = np.round(clips.astype(np.float64) * 32767.0).astype(np.int16)
    x = torch.from_numpy(pcm).to(dev).to(torch.float32) / torch.tensor(32767.0, device=dev)
    feats, base = spectral_threshold_features(x, chip_smoke.TUNE_BASE, device=dev)
    combos = generate_param_combinations(chip_smoke.TUNE_GRID)
    C = len(combos)
    gen = torch.Generator(device=dev).manual_seed(36)

    def rand(lo, hi):
        return lo + (hi - lo) * torch.rand(C, generator=gen, device=dev)

    distinct = sweep.SweepParams(rand(0.0, 4.0), rand(-0.5, 3.5), rand(-0.5, 3.5), rand(-0.5, 4.0),
                                 torch.randint(0, 5, (C,), generator=gen, device=dev,
                                               dtype=torch.int32), rand(-0.5, 5.0))
    B, T = feats["td_crest"].shape
    out = {f"{C:,} combos x {B} x {T}": (feats, combo_sweep_params(combos, base, dev)),
           "one combo": (feats, combo_sweep_params([combos[1234]], base, dev))}
    for i in range(4):
        out[f"mesh block {i}, 1,024 combos"] = (
            feats, combo_sweep_params(combos[i * 1024 : (i + 1) * 1024], base, dev))
    out[f"{C:,} combos, every threshold distinct"] = (feats, distinct)
    return out


def time_k5(tsn, cases: dict, exact: bool = True) -> dict:
    import torch

    import chip_smoke

    out = {}
    for label, (G, nc, cfg) in cases.items():
        got = tsn._gain_time_smooth_cuda(G, nc, cfg)
        ref = tsn._gain_time_smooth_plain(G, nc, cfg)
        torch.cuda.synchronize()
        same, d = chip_smoke.same_bits(got, ref)
        if exact and not same:
            raise SystemExit(f"K5 {label}: not the plain loop's bits (max|d| {d:.3e})")
        fn = lambda: tsn._gain_time_smooth_cuda(G, nc, cfg)  # noqa: E731
        out[label] = {"same_bits": same, "graph_ms": chip_smoke.graph_ms(fn),
                      "kernels": chip_smoke.launch_breakdown(fn), "call_ms": call_ms(fn)}
        print(f"K5 {label}: {out[label]}")
    return out


def time_k10(sweep, cases: dict, exact: bool = True) -> dict:
    import torch

    import chip_smoke

    out = {}
    for label, (feats, params) in cases.items():
        ops = sweep.k10_operands(feats, params)
        got = sweep._launch_k10(*ops)
        ref = sweep._decision_counts_plain(feats, params)
        torch.cuda.synchronize()
        same = torch.equal(got, ref)
        if exact and not same:
            raise SystemExit(f"K10 {label}: counts differ from the plain version on "
                             f"{int((got != ref).sum())} of {got.numel()}")
        fn = lambda: sweep._launch_k10(*ops)  # noqa: E731
        planned = isinstance(ops[2], int)  # this tree's operands: slice size, rows, ...
        out[label] = {"combos": int(got.shape[0]), "slice": ops[2] if planned else None,
                      "rows": int(ops[3].shape[1]) if planned else None, "same_counts": same,
                      "graph_ms": chip_smoke.graph_ms(fn),
                      "kernels": chip_smoke.launch_breakdown(fn),
                      "call_ms": call_ms(lambda: sweep._decision_counts_cuda(feats, params))}
        print(f"K10 {label}: {out[label]}")
    return out


def variant_source(csrc: Path, name: str) -> Path:
    """A copy of ``csrc`` with the source edits of variant ``name``."""
    out = REPO / "build" / "k5k10_variants" / name
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(csrc, out)
    for source, text, replacement in VARIANTS[name][2]:
        src = (out / source).read_text()
        if src.count(text) != 1:
            raise SystemExit(f"variant {name}: {source} has no single {text!r}")
        (out / source).write_text(src.replace(text, replacement))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--out", default=None, help="also write the JSON line to this file")
    ap.add_argument("--variant", action="append", default=[], choices=sorted(VARIANTS))
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))

    import torch

    if not torch.cuda.is_available():
        print("time_k5_k10: no CUDA device", file=sys.stderr)
        return 1
    from audio_processing_tools_tpu_torch import _kernels
    from audio_processing_tools_tpu_torch.models import spectral_noise as tsn
    from audio_processing_tools_tpu_torch.ops import sweep

    smi = smi_query("name,power.limit")
    print(smi)
    lib = _kernels.build()
    keep = False  # ptxas's lines for K5's and K10's kernels
    for ln in lib.build_log.splitlines():
        if "Compiling entry function" in ln:
            keep = "gain_time_smooth" in ln or "decision_sweep" in ln
        if keep and "ptxas info" in ln:
            print(ln.strip())
    dev = torch.device("cuda", 0)
    k5, k10 = k5_cases(dev), k10_cases(dev)
    first = next(iter(k5.values()))
    result = {"root": args.root, "card": smi, "k5": time_k5(tsn, k5), "k10": time_k10(sweep, k10),
              "sm_clock_k5": sm_clock_under(lambda: tsn._gain_time_smooth_cuda(*first)),
              "variants": {}}
    print(f"SM clock under K5: {result['sm_clock_k5']}")

    csrc = _kernels.CSRC
    for name in args.variant:
        kernel, exact, edits, consts = VARIANTS[name]
        saved = {k: getattr(sweep, k) for k in consts}
        for k, v in consts.items():
            setattr(sweep, k, v)
        if edits:
            _kernels.CSRC = variant_source(csrc, name)
            _kernels._LIBRARY = None
        if kernel == "k5":
            result["variants"][name] = time_k5(tsn, k5, exact)
        else:
            result["variants"][name] = time_k10(sweep, k10, exact)
        for k, v in saved.items():
            setattr(sweep, k, v)
        _kernels.CSRC, _kernels._LIBRARY = csrc, None
    line = json.dumps(result)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
