#!/usr/bin/env python3
"""Device busy time of the PyTorch port's main-path batch, from torch.profiler.

    python3 tools/profile_torch_batch.py [--root DIR] [--config NAME]

Runs ``SpectralNoiseEngine.process_batch`` in one of the configurations of
``chip_smoke.py`` (``classifier_only``, the default; ``default``, the
engine's default suppressor; ``audio_out``) on 128 synthetic 10 s clips
already on the card, or one step of the live streaming path
(``stream``: ``StreamingRainDetector.process_chunk_batch`` on 64 streams x
2 s chunks, int16 on the card, the state carried from step to step;
``stream_audio``: the same with denoised audio out; a "batch" is then one
chunk step), or the band-noise estimator (``band_noise``:
``band_noise_process`` on chip_smoke's 128 synthetic 10 s band-noise
clips), the legacy RoE classifier (``roe``: ``models/roe.py::_roe_batch``
with the default ``RoeConfig`` but no spectra, on chip_smoke's 128
synthetic 10 s clips) or the mel classifier (``mel``:
``MelRainClassifier.process_batch`` on the same clips): 25 warm batches,
25 timed on the host clock, 5 under the profiler.  Prints one JSON line: device busy ms per batch (the sum of
kernel and copy times on the card), host-clock ms per batch without and with
the profiler, kernels per batch, the busy share (busy over the unprofiled
host clock), the device ms and launches per batch of the costliest kernels,
the copy kernels per batch, and which kernel ran on the card just before
each launch of K2 (the noise PSD tracker).  ``--root`` imports the port and
``chip_smoke.py`` from another checkout, so that two trees can be compared
on one card, one process each.
Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from collections import Counter, defaultdict
from pathlib import Path

WARM = 25  # batches before timing, and batches timed on the host clock
BATCHES = 5  # batches profiled
TOP = 12  # kernel lines reported
CONFIGS = {"classifier_only": "PARAMS", "default": "DEFAULT_PARAMS", "audio_out": "AUDIO_PARAMS",
           "stream": "STREAM_PARAMS", "stream_audio": "STREAM_AUDIO", "band_noise": None,
           "roe": None, "mel": None}
#: K2's kernel, as the one-thread-per-lane source and the staged-tile source name it
K2_KERNEL = re.compile(r"noise_psd_track_kernel|PsdTracker")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--config", choices=sorted(CONFIGS), default="classifier_only")
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
    params = getattr(chip_smoke, CONFIGS[args.config] or "PARAMS")
    if args.config == "band_noise":
        from audio_processing_tools_tpu_torch.models import band_noise as tbn

        x = torch.from_numpy(chip_smoke.band_noise_clips(chip_smoke.BATCH)).to(dev)
        cfg = tbn.build_band_noise_config({"sample_rate": chip_smoke.FS})

        def step():
            return tbn.band_noise_process(x, cfg)
    elif args.config in ("roe", "mel"):
        from audio_processing_tools_tpu_torch.models import mel_classifier, roe

        x = torch.from_numpy(chip_smoke.synth_clips()[0]).to(dev)
        if args.config == "roe":
            cfg = roe.build_roe_config(return_spectra=False)

            def step():
                return roe._roe_batch(x, cfg)
        else:
            clf = mel_classifier.MelRainClassifier(device=dev)
            clf.setup({"sample_rate": chip_smoke.FS})

            def step():
                return clf.process_batch(x)
    elif args.config.startswith("stream"):
        from audio_processing_tools_tpu_torch.models.streaming import StreamingRainDetector

        n_chunks = 2 * WARM + BATCHES + 1
        pcm_np, _ = chip_smoke.synth_streams(chip_smoke.STREAMS,
                                             n_chunks * chip_smoke.CHUNK / chip_smoke.FS)
        pcm = torch.from_numpy(pcm_np).to(dev)
        det = StreamingRainDetector(device=dev)
        det.setup(dict(params))
        live = {"state": det.init_state_batch(pcm.shape[0]), "chunk": 0}

        def step():
            c, L = live["chunk"], chip_smoke.CHUNK
            live["state"], out = det.process_chunk_batch(
                live["state"], pcm[:, c * L : (c + 1) * L].to(torch.float32) / 32767.0)
            live["chunk"] += 1
            return out
    else:
        clips, _ = chip_smoke.synth_clips()
        pcm = torch.from_numpy((clips * 32767.0).astype("int16")).to(dev)
        eng = SpectralNoiseEngine(build_noise_config(chip_smoke.FS, params), device=dev)

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
    per_count = Counter()
    n_kernels = 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # kernels whose names agree in their first 90 characters are one line
            per_name[e.key[:90]] += e.self_device_time_total / 1e3 / BATCHES
            per_count[e.key[:90]] += e.count
            n_kernels += e.count
    busy = sum(per_name.values())
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:TOP]
    copies = {k: [v, per_count[k] / BATCHES] for k, v in per_name.items() if "copy" in k.lower()}
    # the device timeline: what ran just before each K2 launch
    timeline = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                      key=lambda e: e.time_range.start)
    before_k2 = Counter(prev.name[:90] for prev, e in zip(timeline, timeline[1:])
                        if K2_KERNEL.search(e.name))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({
        "root": args.root, "config": args.config, "card": smi, "batches": BATCHES,
        "device_busy_ms_per_batch": busy, "host_ms_per_batch": host_ms,
        "host_ms_per_batch_profiled": profiled_ms,
        "busy_share": busy / host_ms, "kernels_per_batch": n_kernels / BATCHES,
        "top_device_ms_per_batch": dict(top),
        "top_launches_per_batch": {k: per_count[k] / BATCHES for k, _ in top},
        "copy_kernels_ms_and_launches_per_batch": copies,
        "kernel_before_k2_per_batch": {k: v / BATCHES for k, v in before_k2.items()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
