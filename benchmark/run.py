#!/usr/bin/env python3
"""Run one cell of the benchmark of ``audio_processing_tools_tpu_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks for.
Set-up makes the cell's backlog of int16 clips on the card from the seed,
builds or loads the port's kernel library and warms up the cell's shapes.
The window then drives the fleet backfill's step (upload, step, readback)
batch after batch for ``--seconds``.  With ``--trace 0`` the last line of
standard output is the cell's end-to-end metrics; with ``--trace 1`` a
traced segment of batches follows the window and the line holds the cell's
per-layer metrics and a breakdown.  After the window the plain reference
checks a sample of the window's answers; the numbers compared and their
limits are the last lines on standard error and the last key of the line.
Exits with a code other than 0, and prints no result line, without the
cards, without the port, or if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level modules no run may load, compared whole
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "audio_processing_tools_tpu"})


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def power_limit() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=20)
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 and r.stdout else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t_start: float):
    """One run of a cell on ``device``; returns the result line's object."""
    import numpy as np
    import torch

    from harness import check, traffic, window
    from harness import trace as tracing
    from harness.spec import reader

    config, mix = cell["config"], cell["mix"]
    on_card = device.type == "cuda"
    marks = [("start", t_start)]
    if on_card:
        from audio_processing_tools_tpu_torch import _kernels

        torch.cuda.init()
        marks.append(("torch and CUDA", time.perf_counter()))
        lib = _kernels.build()
        marks.append(("kernel library", time.perf_counter()))
        print(f"kernel library {lib.path.parent.name}: nvcc {lib.build_seconds:.3f} s "
              f"(0 when it was already built)", file=sys.stderr)
    backlog = traffic.make_backlog(mix, config, seed, device)
    nb, B = backlog.shape[0], backlog.shape[1]
    marks.append(("backlog", time.perf_counter()))
    bf = window.Backfill(config, device)
    for j in range(int(mix["warmup_batches"])):
        bf.batch(backlog[j % nb])
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    marks.append(("warm-up", time.perf_counter()))
    setup_s = marks[-1][1] - t_start
    print("set-up: " + ", ".join(f"{name} {t - marks[i][1]:.3f} s"
                                 for i, (name, t) in enumerate(marks[1:])), file=sys.stderr)

    idx = check.sample(seed, nb * B, int(config["check_clips"]))
    w = window.run(bf, backlog, seconds, check.keep_rows(idx, B), first=int(mix["warmup_batches"]))
    peak = torch.cuda.max_memory_allocated() if on_card else None
    n = len(w["times"])
    clip_sec = float(config["clip_sec"])
    print(f"window: {n} batches of {B} clips in {w['seconds']:.3f} s; setup {setup_s:.3f} s",
          file=sys.stderr)

    result = {"correct": False, "attempted": n * B, "failed": 0, "metrics": {}}
    tr = None
    if trace:
        after = int(mix["warmup_batches"]) + n
        tr = tracing.traced(lambda j: bf.batch(backlog[(after + j) % nb]),
                            int(mix["trace_batches"]))
        ctx = SimpleNamespace(config=config, mix=mix, clips_per_batch=B,
                              batch_seconds=w["times"], trace=tr, peak_bytes=peak,
                              device_name=torch.cuda.get_device_name(0) if on_card else "cpu")
        for m in cell["per_layer"]:
            value = reader(m["name"]).read(ctx)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {"audio_s_per_s": n * B * clip_sec / w["seconds"],
                  "batch_p95_ms": window.p95_ms(w["times"]),
                  "setup_s": setup_s}
        for m in cell["end_to_end"]:
            result["metrics"][m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    del bf
    if on_card:
        torch.cuda.empty_cache()
        result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                            "count": int(cell["workload"]["chips"]),
                            "memory_peak_bytes": int(peak)}
    else:
        result["device"] = {"platform": "cpu", "kind": "cpu", "count": 1,
                            "memory_peak_bytes": 0}
    if tr is not None:
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": [list(kv) for kv in tr.device_ops()],
                               "idle_gaps": [list(kv) for kv in tr.idle_gaps()]}
    result["batches"] = n
    result["window_s"] = w["seconds"]
    result["batch_ms"] = {"median": float(np.median(w["times"])) * 1e3,
                          "p95": window.p95_ms(w["times"]), "count": n}

    verdict = check.judge(config, idx, backlog, w)
    result["correct"] = verdict["correct"]
    result["failed"] = verdict["failed"]
    result["answers_compared"] = verdict["compared"]
    result["checks"] = verdict["numbers"]
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # caches at fixed places inside the checkout: the port builds its kernel
    # library under build/ there, and nothing else of the run compiles
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / "build" / "bench_cache" / sub)
    sys.path[:0] = [str(HERE), str(ROOT)]

    import torch

    from harness import check
    from harness.spec import cell as find_cell
    from harness.spec import load_benchmark

    cell = find_cell(load_benchmark(), args.workload)
    chips = int(cell["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), T_START)
    print(f"card: {power_limit()}", file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"refused: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    check.report(result["checks"], result["answers_compared"])
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
