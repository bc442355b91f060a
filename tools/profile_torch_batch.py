#!/usr/bin/env python3
"""Device busy time of the PyTorch port's main-path batch, from torch.profiler.

    python3 tools/profile_torch_batch.py [--root DIR]

Runs ``SpectralNoiseEngine.process_batch`` (classifier-only, the defaults of
``chip_smoke.py``) on 128 synthetic 10 s clips already on the card: 25 warm
batches, 25 timed on the host clock, 5 under the profiler.  Prints one JSON
line: device busy ms per batch (the sum of kernel and copy times on the
card), host-clock ms per batch without and with the profiler, kernels per
batch, the busy share (busy over the unprofiled host clock), and the device
ms per batch of the costliest kernels.  ``--root`` imports the port and
``chip_smoke.py`` from another checkout, so that two trees can be compared
on one card, one process each.
Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

WARM = 25  # batches before timing, and batches timed on the host clock
BATCHES = 5  # batches profiled
TOP = 12  # kernel lines reported


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_batch: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from audio_processing_tools_tpu_torch.config import build_noise_config
    from audio_processing_tools_tpu_torch.models.spectral_noise import SpectralNoiseEngine

    dev = torch.device("cuda", 0)
    clips, _ = chip_smoke.synth_clips()
    pcm = torch.from_numpy((clips * 32767.0).astype("int16")).to(dev)
    eng = SpectralNoiseEngine(build_noise_config(chip_smoke.FS, chip_smoke.PARAMS), device=dev)

    def step():
        return eng.process_batch(pcm.to(torch.float32) / 32767.0)

    for _ in range(WARM):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(WARM):
        step()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / WARM
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(BATCHES):
            step()
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3 / BATCHES

    per_name = defaultdict(float)
    n_kernels = 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # kernels whose names agree in their first 90 characters are one line
            per_name[e.key[:90]] += e.self_device_time_total / 1e3 / BATCHES
            n_kernels += e.count
    busy = sum(per_name.values())
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:TOP]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({
        "root": args.root, "card": smi, "batches": BATCHES,
        "device_busy_ms_per_batch": busy, "host_ms_per_batch": host_ms,
        "host_ms_per_batch_profiled": profiled_ms,
        "busy_share": busy / host_ms, "kernels_per_batch": n_kernels / BATCHES,
        "top_device_ms_per_batch": dict(top),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
