#!/usr/bin/env python3
"""Device time of K1's chirp-z route at each candidate transform size, for
geometries whose complex length has a prime factor above 31, against
``stft_power``.

    python3 tools/time_chirp_sizes.py [--geometries 296/148 1009/504 ...] [--out FILE]

On chip_smoke's 128 synthetic 10 s clips: for each geometry, the chirp-z
launcher is called over the smallest 7-smooth size M from 2L - 1 up to 4L
and every one with at most one pass more than the fewest
(``ops/spectrogram.py::chirp_size`` picks the fewest passes, then the
smallest size) whose block fits, with
the tables ``chirpz_tables(n_fft, M)``; each output is held within 1e-5 of
``stft_power``'s maximum and its device ms per call taken from a CUDA graph
of 20 calls (``chip_smoke.graph_ms``), the sizes in turns (forward, then
backward, the mean of both).  Prints the card's name and power limit, a
line per geometry, then one JSON line.  Needs a CUDA card; imports nothing
of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--geometries", nargs="+",
                    default=["296/148", "1009/504", "1031/515", "2062/1031"])
    ap.add_argument("--out", default=None, help="also write the JSON line to this file")
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_chirp_sizes: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from audio_processing_tools_tpu_torch import _kernels
    from audio_processing_tools_tpu_torch.ops import spectrogram as tspec
    from audio_processing_tools_tpu_torch.ops.stft import stft_power

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)
    lib = _kernels.build()
    dev = torch.device("cuda", 0)
    x = torch.from_numpy(cs.synth_clips()[0]).to(dev)
    B, N = x.shape
    result = {"card": smi, "chosen": {}, "ms": {}, "stft_power_ms": {}}
    for geo in args.geometries:
        n_fft, hop = (int(v) for v in geo.split("/"))
        L = n_fft // 2 if n_fft % 2 == 0 else n_fft
        sizes = [m for m in tspec._seven_smooth_between(max(2, 2 * L - 1), 4 * L)
                 if tspec.tile_plan(m) is not None]
        fewest = min(len(tspec.mixed_radices(m)) for m in sizes)
        sizes = sorted({m for m in sizes if len(tspec.mixed_radices(m)) <= fewest + 1}
                       | {min(sizes)})
        win, tw = (torch.from_numpy(a).to(dev).contiguous()
                   for a in tspec.kernel_tables(n_fft))
        T = 1 + N // hop
        out = torch.empty((B, n_fft // 2 + 1, T), device=dev)
        ref = stft_power(x, n_fft=n_fft, hop=hop)
        calls = {}
        for M in sizes:
            tabs = [torch.from_numpy(a).to(dev).contiguous()
                    for a in tspec.chirpz_tables(n_fft, M)]
            plan = tspec.tile_plan(M)

            def call(M=M, tabs=tabs, plan=plan):
                lib.check(lib.lib.apt_spectrogram_power_chirpz(
                    x.data_ptr(), win.data_ptr(), tw.data_ptr(), *(t.data_ptr() for t in tabs),
                    out.data_ptr(), B, N, T, n_fft, hop, n_fft // 2, M, plan.frame_tile,
                    plan.smem_bytes, _kernels.stream_of(x)), "spectrogram_power")

            call()
            torch.cuda.synchronize()
            d = float((out - ref).abs().max())
            if d > 1e-5 * float(ref.abs().max()):
                raise SystemExit(f"K1 chirp-z {n_fft}/{hop} over {M}: max|d| {d:.3e}")
            calls[M] = call
        ms = {M: [] for M in calls}
        for M in list(calls) + list(calls)[::-1]:
            ms[M].append(cs.graph_ms(calls[M]))
        ms = {M: float(np.mean(v)) for M, v in ms.items()}
        lib_ms = cs.graph_ms(lambda: stft_power(x, n_fft=n_fft, hop=hop))
        result["chosen"][geo] = tspec.chirp_size(L)
        result["ms"][geo] = {str(M): v for M, v in ms.items()}
        result["stft_power_ms"][geo] = lib_ms
        print(f"{geo} (L {L}, chosen {tspec.chirp_size(L)}): stft_power {lib_ms:.4f} ms; "
              + ", ".join(f"{M} ({len(tspec.mixed_radices(M))} passes) {v:.4f}"
                          for M, v in ms.items()))
    line = json.dumps(result)
    print(line)
    if args.out:
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
