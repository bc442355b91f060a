#!/usr/bin/env python3
"""Whether a cell's timing depends on its traffic's share of rain clips.

    python3 benchmark/mixcheck.py --workload <cell> --shares 0.5 0 1
        [--seeds S ...] [--seconds 20] [--out FILE]

In one process on the card, for each seed and each share in turn (the
shares in order, then reversed, so that a drift of the machine shows as
one), one traced run of the cell through ``run.py``'s own run with the mix's
``rain_share`` set to that share.  One JSON line a run, on standard output
and appended to ``--out``: the share, the seed, ``audio_s_per_s`` and
``batch_p95_ms`` of the window, the traced ``kernels_per_batch`` and
``host_syncs_per_batch``, the idle share and ``correct``.  The benchmark's
own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--shares", type=float, nargs="+", default=[0.5, 0.0, 1.0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[2**31 + 101])
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    import run
    from harness.spec import cell as find_cell
    from harness.spec import load_benchmark

    dev = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    order = args.shares + args.shares[::-1]
    for seed in args.seeds:
        for share in order:
            c = find_cell(load_benchmark(), args.workload)
            c["mix"]["rain_share"] = share
            c["config"]["check_clips"] = min(int(c["config"]["check_clips"]), 256)
            names = {m["name"] for m in c["per_layer"]}
            c["per_layer"] = [m for m in c["per_layer"]
                              if m["name"] in ("kernels_per_batch", "host_syncs_per_batch",
                                               "device_idle_share")]
            assert len(c["per_layer"]) == 3, names
            r = run.run_cell(c, seed, args.seconds, True, dev,
                             time.perf_counter())
            clip_sec = float(c["config"]["clip_sec"])
            rec = {"workload": args.workload, "share": share, "seed": seed,
                   "audio_s_per_s": r["attempted"] * clip_sec / r["window_s"],
                   "batch_p95_ms": r["batch_ms"]["p95"], "batches": r["batches"],
                   **{k: v["value"] for k, v in r["metrics"].items()},
                   "correct": r["correct"], "checks": r["checks"]}
            line = json.dumps(rec)
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
