#!/usr/bin/env python3
"""Device time of K1's mixed-radix route at each frame tile a block can
hold, for the sizes users type, against ``stft_power``.

    python3 tools/time_mixed_tiles.py [--sizes 384 400 640 768 2048] [--out FILE]

On chip_smoke's 128 synthetic 10 s clips, hop n_fft / 2: for every
power-of-two frame tile from 1 to 32 whose block fits shared memory, K1's
mixed launcher is called with that tile (``ops/spectrogram.py::
mixed_launch_plan`` picks one of them), its output held within 1e-5 of
``stft_power``'s maximum, and its device ms per call taken from a CUDA graph
of 20 calls (``chip_smoke.graph_ms``).  Prints the card's name and power
limit, a line per size, then one JSON line.  Needs a CUDA card; imports
nothing of JAX.
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
    ap.add_argument("--sizes", type=int, nargs="+", default=[384, 400, 640, 768, 2048])
    ap.add_argument("--out", default=None, help="also write the JSON line to this file")
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))

    import torch

    if not torch.cuda.is_available():
        print("time_mixed_tiles: no CUDA device", file=sys.stderr)
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
    result = {"card": smi, "plan": {}, "ms": {}, "stft_power_ms": {}}
    for n_fft in args.sizes:
        hop = n_fft // 2
        if tspec.k1_route(n_fft, hop) != "mixed":
            raise SystemExit(f"n_fft {n_fft} does not take the mixed route")
        win, tw = (torch.from_numpy(a).to(dev).contiguous() for a in tspec.kernel_tables(n_fft))
        T = 1 + N // hop
        out = torch.empty((B, n_fft // 2 + 1, T), device=dev)
        ref = stft_power(x, n_fft=n_fft, hop=hop)
        ms = {}
        for ft in (1, 2, 4, 8, 16, 32):
            smem = tspec._mixed_smem(n_fft, ft)
            if smem > tspec.SMEM_LIMIT:
                continue

            def call(ft=ft, smem=smem):
                lib.check(lib.lib.apt_spectrogram_power_mixed(
                    x.data_ptr(), win.data_ptr(), tw.data_ptr(), out.data_ptr(), B, N, T, n_fft,
                    hop, n_fft // 2, ft, smem, _kernels.stream_of(x)), "spectrogram_power")

            call()
            torch.cuda.synchronize()
            d = float((out - ref).abs().max())
            if d > 1e-5 * float(ref.abs().max()):
                raise SystemExit(f"K1 mixed {n_fft}/{hop}, tile {ft}: max|d| {d:.3e}")
            ms[ft] = cs.graph_ms(call)
        result["plan"][n_fft] = tspec.mixed_launch_plan(n_fft).frame_tile
        result["ms"][n_fft] = ms
        result["stft_power_ms"][n_fft] = cs.graph_ms(lambda: stft_power(x, n_fft=n_fft, hop=hop))
        print(f"K1 mixed {n_fft}/{hop} {tuple(x.shape)}: ms by frame tile "
              + ", ".join(f"{ft}: {v:.4f}" for ft, v in ms.items())
              + f" (the plan's {result['plan'][n_fft]}); stft_power "
              f"{result['stft_power_ms'][n_fft]:.4f}")
    line = json.dumps(result)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
