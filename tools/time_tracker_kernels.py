#!/usr/bin/env python3
"""Device time of K2 and K3 (``csrc/trackers.cu``) at the main path's
shapes, for the committed launch plan and for variants of it.

    python3 tools/time_tracker_kernels.py [--variant FRAME_TILE,MAX_LANES,TARGET_BLOCKS,THREADS ...]

Makes the main path's tracker inputs from ``chip_smoke.py``'s 128 synthetic
10 s clips: the engine's band view of the spectrogram (128, 71, 873) for K2
and the stacked flux rows (128, 6, 873) for K3.  For the committed source,
and for each variant (a copy of ``csrc/`` under ``build/`` with other plan
constants, and the Python plan set to match), it builds the kernels, checks
both against their plain loops (max|d| must be 0, else it exits non-zero),
and times each as ``chip_smoke.py`` does: device ms per launch from a CUDA
graph of 20 back-to-back launches, and ms per host-launched call between
CUDA events.  Prints one JSON line.  Needs a CUDA card; imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def variant_source(csrc: Path, frame_tile: int, max_lanes: int, target_blocks: int,
                   threads: int) -> Path:
    """A copy of ``csrc`` with the tracker plan's constants replaced."""
    out = (REPO / "build" / "tracker_variants"
           / f"ft{frame_tile}_l{max_lanes}_b{target_blocks}_t{threads}")
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(csrc, out)
    src = (out / "trackers.cu").read_text()
    for name, value in (("kFrameTile", frame_tile), ("kLgTile", frame_tile.bit_length() - 1),
                        ("kMaxLanes", max_lanes), ("kTargetBlocks", target_blocks),
                        ("kThreads", threads)):
        src, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};", src)
        if n != 1:
            raise RuntimeError(f"trackers.cu: no single definition of {name}")
    (out / "trackers.cu").write_text(src)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", action="append", default=[],
                    help="FRAME_TILE,MAX_LANES,TARGET_BLOCKS,THREADS (frame tile a power of "
                         "two, threads a multiple of 32 from 64)")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_tracker_kernels: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from audio_processing_tools_tpu_torch import _kernels
    from audio_processing_tools_tpu_torch.config import build_noise_config
    from audio_processing_tools_tpu_torch.models.frame_classifier import BandGeometry, _mode_flux
    from audio_processing_tools_tpu_torch.models.spectral_noise import SpectralNoiseEngine
    from audio_processing_tools_tpu_torch.ops import trackers as ttr
    from audio_processing_tools_tpu_torch.ops.stft import stft_power

    dev = torch.device("cuda", 0)
    cfg = build_noise_config(chip_smoke.FS, chip_smoke.PARAMS)
    geo = BandGeometry(cfg)
    clips, _ = chip_smoke.synth_clips()
    P = stft_power(torch.from_numpy(clips).to(dev))
    P_view = P[:, int(geo.band_rows[0]): int(geo.band_rows[-1]) + 1, :]
    B, K, T = P_view.shape
    psd = ttr.make_psd_params(
        cfg_q=cfg.q, win_sec=cfg.win_sec, frames_per_sec=chip_smoke.FS / cfg.hop,
        ema_up=cfg.ema_up, ema_down=cfg.ema_down, eps=cfg.eps,
        noise_psd_max_ratio=cfg.noise_psd_max_ratio)
    no_rain = torch.zeros((B, T), dtype=torch.bool, device=dev)
    P_det, _ = SpectralNoiseEngine(cfg, device=dev)._detector_input(P_view, chip_smoke.FS)
    _, _, flux_modes, by_mode = _mode_flux(P_det, geo.mode_masks, geo.primary_mask, None)
    stacked = torch.cat([flux_modes[:, None, :], by_mode], dim=1).contiguous()
    bc = ttr._baseline_consts(20.0, chip_smoke.FS / cfg.hop, 0.5, 0.0, 1.0)
    ref2 = ttr._noise_psd_track_plain(P_view, no_rain, psd)
    ref3 = ttr._baseline_plain(stacked, bc)

    committed = (ttr.TRACKER_FRAME_TILE, ttr.TRACKER_MAX_LANES, ttr.TRACKER_TARGET_BLOCKS,
                 ttr.TRACKER_THREADS)
    csrc = _kernels.CSRC
    variants = [None] + [tuple(int(v) for v in spec.split(",")) for spec in args.variant]
    results = []
    for var in variants:
        plan_consts = committed if var is None else var
        (ttr.TRACKER_FRAME_TILE, ttr.TRACKER_MAX_LANES, ttr.TRACKER_TARGET_BLOCKS,
         ttr.TRACKER_THREADS) = plan_consts
        _kernels.CSRC = csrc if var is None else variant_source(csrc, *var)
        _kernels._LIBRARY = None
        lib = _kernels.build()
        usage = [ln.strip() for ln in lib.build_log.splitlines()
                 if any(w in ln for w in ("Function properties", "registers", "spill"))]
        d2 = float((ttr._noise_psd_track_cuda(P_view, no_rain, psd) - ref2).abs().max())
        d3 = float((ttr._baseline_cuda(stacked, bc) - ref3).abs().max())
        if d2 != 0.0 or d3 != 0.0:
            print(f"time_tracker_kernels: variant {plan_consts} differs from the plain loops: "
                  f"K2 {d2:.3e}, K3 {d3:.3e}", file=sys.stderr)
            return 1
        k2 = lambda: ttr._noise_psd_track_cuda(P_view, no_rain, psd)  # noqa: E731
        k3 = lambda: ttr._baseline_cuda(stacked, bc)  # noqa: E731
        results.append({
            "frame_tile": plan_consts[0], "max_lanes": plan_consts[1],
            "target_blocks": plan_consts[2], "threads": plan_consts[3],
            "k2_plan": ttr.tracker_launch_plan("noise_psd_track", B * K, T)._asdict(),
            "k3_plan": ttr.tracker_launch_plan("causal_low_quantile_baseline",
                                               stacked.numel() // T, T)._asdict(),
            "k2_device_ms": chip_smoke.graph_ms(k2),
            "k3_device_ms": chip_smoke.graph_ms(k3),
            "k2_call_ms": float(np.median(chip_smoke.cuda_times(k2, 40))),
            "k3_call_ms": float(np.median(chip_smoke.cuda_times(k3, 40))),
            "ptxas": usage,
        })
        print(json.dumps(results[-1]), file=sys.stderr)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi, "shapes": {"k2": [B, K, T], "k3": list(stacked.shape)},
                      "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
