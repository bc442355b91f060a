#!/usr/bin/env python3
"""Backfill scaling of the PyTorch port: files/s at 1, 2 and 4 processes.

    python3 tools/bench_torch_backfill_scaling.py [--clips 16] [--sec 2.0]
        [--nprocs 1 2 4] [--device cuda|cpu]

Counterpart of ``tools/bench_backfill_scaling.py``: runs the real
``python -m audio_processing_tools_tpu_torch.cli.backfill`` over a
synthetic corpus (``make_labeled_corpus(seed=11)``, half heavy rain, half
noise, written as MARK files) as 1, 2 and 4 processes joined over gloo,
and prints files/s and the parallel efficiency for each n.  Every n must
give the same ``total_clips``, ``total_rain_frames`` and
``total_rain_clips``.

On the card (the default) every process drives the host's cards; on a
one-card host all n processes share the one card, and the JSON line says
so.  ``--device cpu`` runs the processes on the CPU (``--cpu-devices 1``).
No Parquet is written: the processes' JSON summaries carry the aggregates
(the card's machine has no pyarrow).  files/s is the corpus over the
slowest process's loop time; ``e2e_wall_s`` adds each process's start,
imports and kernel load.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
TOTALS = ("total_clips", "total_rain_frames", "total_rain_clips")


def _run_cli(extra, clip_sec: float, device: str) -> subprocess.Popen:
    cmd = [sys.executable, "-m", "audio_processing_tools_tpu_torch.cli.backfill",
           "--clip-sec", str(clip_sec), "--batch", "8", *extra]
    if device == "cpu":
        cmd += ["--cpu-devices", "1"]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=str(REPO))


def _summary(stdout: str) -> dict:
    for line in stdout.splitlines():
        if line.startswith("{"):
            return json.loads(line)
    raise RuntimeError(f"no JSON summary:\n{stdout}")


def measure(corpus: str, nproc: int, clip_sec: float, nfiles: int, device: str) -> dict:
    """One run of ``nproc`` coordinated processes over the corpus."""
    common = ["--input-type", "LocalPath", "--path", corpus]
    if nproc > 1:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        common += ["--distributed", "--coordinator", f"localhost:{port}",
                   "--num-processes", str(nproc)]
    t0 = time.perf_counter()
    procs = [_run_cli(common + (["--process-id", str(i)] if nproc > 1 else []), clip_sec, device)
             for i in range(nproc)]
    try:
        outs = [p.communicate(timeout=900) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for p, (_, se) in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"n={nproc} rc={p.returncode}:\n{se[-2000:]}")
    summaries = [_summary(so) for so, _ in outs]
    # aggregate equality across processes (the correctness half of the story)
    for k in TOTALS:
        if len({s[k] for s in summaries}) != 1:
            raise RuntimeError(f"n={nproc}: processes disagree on {k}: {summaries}")
    # the pipeline's wall time is the slowest process's loop; the end-to-end
    # wall adds the processes' start, imports and kernel load
    pipe_wall = max(s["wall_time_sec"] for s in summaries)
    return {
        "nproc": nproc,
        "files_per_sec": nfiles / pipe_wall,
        "pipeline_wall_s": pipe_wall,
        "e2e_wall_s": wall,
        "aggregates": {k: summaries[0][k] for k in TOTALS},
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clips", type=int, default=16)
    ap.add_argument("--sec", type=float, default=2.0)
    ap.add_argument("--nprocs", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()

    sys.path.insert(0, str(REPO))
    from audio_processing_tools_tpu_torch.utils.corpus import make_labeled_corpus, write_corpus_dir

    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("bench_torch_backfill_scaling: no CUDA device (pass --device cpu for a run "
                  "on the CPU)", file=sys.stderr)
            return 1
        cards = torch.cuda.device_count()
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
        placement = (f"every process drives all {cards} card(s) of the host" if cards > 1 else
                     "all processes share the one card")
    else:
        card, placement = "cpu", "every process on the CPU"

    per_kind = max(1, args.clips // 2)
    clips, labels, kinds = make_labeled_corpus(
        seed=11, seconds=args.sec,
        counts={"rain_heavy": per_kind, "noise": args.clips - per_kind},
    )
    rows = []
    with tempfile.TemporaryDirectory() as td:
        corpus = os.path.join(td, "corpus")
        write_corpus_dir(corpus, clips, labels, kinds)
        for n in args.nprocs:
            r = measure(corpus, n, args.sec, len(clips), args.device)
            rows.append(r)
            print(f"# n={n}: {r['files_per_sec']:.2f} files/s (pipeline "
                  f"{r['pipeline_wall_s']} s, e2e {r['e2e_wall_s']:.1f} s)", file=sys.stderr)
    base = rows[0]["files_per_sec"]
    for r in rows:
        r["efficiency_vs_n1"] = r["files_per_sec"] / (base * r["nproc"])
    agg0 = rows[0].pop("aggregates")
    for r in rows[1:]:
        agg = r.pop("aggregates")
        if agg != agg0:
            raise RuntimeError(f"aggregates drift across n: {agg} against {agg0}")
    print(json.dumps({"clips": len(clips), "clip_sec": args.sec, "device": card,
                      "placement": placement, "host_cores": os.cpu_count(),
                      "aggregates": agg0, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
