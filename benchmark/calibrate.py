#!/usr/bin/env python3
"""Readings that the limits of ``correct`` are set from, for one cell.

    python3 benchmark/calibrate.py --workload <cell> --seeds S [S ...]
        [--control-seeds S [S ...]] [--controls bf16 tf32] [--seconds 3] [--out FILE]

In one process on the card, for each of ``--seeds``: a short window of the
cell at its own load and the numbers that ``run.py`` compares, taken with
no limit (the program's readings).  For each of ``--control-seeds``, the
controls on the same sample of clips: ``bf16``, the plain reference put in
the program's place with each stage's output rounded through bfloat16 (on
the CPU); ``tf32``, the program with its float32 matrix products in TF32
(``torch.backends.cuda.matmul.allow_tf32``), a short window of it.  One
JSON line a reading, on standard output and appended to ``--out``: each
number, and for each check how many sampled clips read above 0, the
largest reading of one clip and the mean over the clips.  The benchmark's
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


def bf16(t):
    import torch

    return t.to(torch.bfloat16).to(t.dtype) if t.is_floating_point() else t


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--controls", nargs="*", default=["bf16"], choices=["bf16", "tf32"])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from harness import check, traffic, window
    from harness.spec import cell as find_cell
    from harness.spec import load_benchmark

    c = find_cell(load_benchmark(), args.workload)
    config, mix = c["config"], c["mix"]
    config = {**config, "checks": [{**k, "limit": None} for k in config["checks"]]}
    dev = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    bf = window.Backfill(config, dev)
    warm = int(mix["warmup_batches"])

    def emit(seed, reading, worst, t0, **extra):
        rec = {"workload": args.workload, "seed": seed, "reading": reading, **extra,
               "numbers": {k["name"]: check.number(k["kind"], worst[k["name"]])
                           for k in config["checks"]},
               "clips_above_0": {n: int(np.count_nonzero(w)) for n, w in worst.items()},
               "largest_of_a_clip": {n: float(w.max(initial=0.0)) for n, w in worst.items()},
               "mean": {n: float(w.mean()) for n, w in worst.items()},
               "seconds": time.perf_counter() - t0}
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    def program_window(backlog, idx):
        nb, B = backlog.shape[:2]
        for j in range(warm):
            bf.batch(backlog[j % nb])
        return window.run(bf, backlog, args.seconds, check.keep_rows(idx, B), first=warm)

    for seed in dict.fromkeys(args.seeds + args.control_seeds):
        t0 = time.perf_counter()
        backlog = traffic.make_backlog(mix, config, seed, dev)
        nb, B = backlog.shape[:2]
        idx = check.sample(seed, nb * B, int(config["check_clips"]))
        w = program_window(backlog, idx)
        v = check.judge(config, idx, backlog, w)
        if seed in args.seeds:
            emit(seed, "program", v["worst"], t0, batches=len(w["times"]),
                 compared=v["compared"], failed=v["failed"])
        if seed not in args.control_seeds:
            continue
        ref, k = v["ref"], idx.size
        every = np.arange(k)
        if "bf16" in args.controls:
            t1 = time.perf_counter()
            got = check.reference(config, backlog.reshape(nb * B, -1)[torch.as_tensor(idx)],
                                  store=bf16)
            emit(seed, "control-bf16", check.worst_by_clip(config, [(got, every)], ref, k), t1,
                 compared=k)
        if "tf32" in args.controls and dev.type == "cuda":
            t1 = time.perf_counter()
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                wt = program_window(backlog, idx)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            answers = [(a, np.flatnonzero(idx // B == b))
                       for a, b in zip(wt["answers"], wt["which"]) if a is not None]
            emit(seed, "control-tf32", check.worst_by_clip(config, answers, ref, k), t1,
                 compared=sum(at.size for _, at in answers))
    return 0


if __name__ == "__main__":
    sys.exit(main())
