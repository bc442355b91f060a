"""Fleet backfill CLI: sharded rain classification over a corpus.

Counterpart of ``audio_processing_tools_tpu/cli/backfill.py`` (BASELINE
config #5, "fleet backfill: multi-host sharded spectrogram +
postprocess/host_analysis aggregation"), with the same flags and the same
one-line JSON summary.

Every process runs this same command.  With ``--distributed`` the processes
join a ``torch.distributed`` group over gloo (``--coordinator host:port``,
``--num-processes``, ``--process-id``; any of them not given is read from
torch's ``env://`` variables ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
``WORLD_SIZE``).  Each process computes the same global batch schedule from
the full key list, loads only its stripe of each global batch, runs the
flagship pipeline on its own cards and sums the corpus aggregates with the
others over gloo; audio never crosses processes.

Two launch models choose the cards.  One process per host (as JAX's
``jax.distributed`` runs): the process drives every card of its host, one
mesh entry each.  One process per card (``torchrun``, which sets
``LOCAL_RANK``): the process drives card ``LOCAL_RANK`` only.  The run is on
the card; ``--cpu-devices N`` runs it on the CPU with a mesh of N CPU
entries.  Without ``--out`` nothing imports pandas.

Example:
    python -m audio_processing_tools_tpu_torch.cli.backfill \
        --input-type LocalPath --path ./test_vectors --clip-sec 10 \
        --out results.parquet
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def _init_process_group(args) -> None:
    import torch.distributed as dist

    kw = {}
    if args.num_processes is not None:
        kw["world_size"] = args.num_processes
    if args.process_id is not None:
        kw["rank"] = args.process_id
    init = f"tcp://{args.coordinator}" if args.coordinator else "env://"
    dist.init_process_group("gloo", init_method=init, **kw)


def _local_mesh(cpu_devices, distributed: bool):
    """The mesh of the cards (or CPU entries) this process drives."""
    import torch

    from audio_processing_tools_tpu_torch.parallel import Mesh, make_mesh

    if cpu_devices:
        return make_mesh(cpu_devices, device="cpu")
    local_rank = os.environ.get("LOCAL_RANK")
    if distributed and local_rank is not None:
        # one process per card: this process's card only
        local, count = int(local_rank), torch.cuda.device_count()
        if not 0 <= local < count:
            raise ValueError(f"LOCAL_RANK {local}, only {count} devices available")
        return Mesh([torch.device("cuda", local)], ("files",))
    return make_mesh(device="cuda")  # every card of the host; raises without one


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--input-type", default="LocalPath",
                    choices=["LocalPath", "RemotePath", "CsvInput", "KeyList"])
    ap.add_argument("--path", default=None, help="corpus dir for LocalPath")
    ap.add_argument("--csv", default=None, help="csv for CsvInput")
    ap.add_argument("--clip-sec", type=float, default=10.0)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--max-files", type=int, default=None)
    ap.add_argument("--clip-rain-min-frames", type=int, default=3)
    ap.add_argument("--out", default=None, help="parquet output path")
    ap.add_argument("--distributed", action="store_true",
                    help="join a torch.distributed process group over gloo")
    ap.add_argument("--coordinator", default=None,
                    help="rendezvous address host:port for --distributed "
                         "(default: MASTER_ADDR / MASTER_PORT)")
    ap.add_argument("--num-processes", type=int, default=None,
                    help="process count for --distributed (default: WORLD_SIZE)")
    ap.add_argument("--process-id", type=int, default=None,
                    help="this process's rank for --distributed (default: RANK)")
    ap.add_argument("--cpu-devices", type=int, default=None,
                    help="run on the CPU with a mesh of N CPU entries")
    ap.add_argument("--dsd", action="store_true",
                    help="also emit per-minute DSD vectors (host_analysis)")
    args = ap.parse_args(argv)

    import torch

    if args.distributed:
        _init_process_group(args)

    from audio_processing_tools_tpu_torch.config import DEFAULT_MODE_BANDS
    from audio_processing_tools_tpu_torch.io.audio import get_keys, get_input_data
    from audio_processing_tools_tpu_torch.parallel import ShardedRainPipeline, local_rows

    FS = 11162
    keys = get_keys(args.input_type, test_vector_path=args.path,
                    csv_inp_file=args.csv)
    if args.max_files:
        keys = keys[: args.max_files]
    dist = torch.distributed
    distributed = dist.is_initialized()
    pid = dist.get_rank() if distributed else 0
    nproc = dist.get_world_size() if distributed else 1
    print(f"[host {pid}/{nproc}] {len(keys[pid::nproc])} of {len(keys)} keys")

    mesh = _local_mesh(args.cpu_devices, distributed)
    device = mesh.devices.flat[0]
    pipe = ShardedRainPipeline(
        {"sample_rate": FS, "detector": {"mode_bands": list(DEFAULT_MODE_BANDS)},
         "clip_rain_min_frames": args.clip_rain_min_frames},
        mesh,
    )

    t0 = time.time()
    rows = []
    agg_totals = {"total_rain_frames": 0, "total_rain_clips": 0, "total_clips": 0}
    n_samp = int(FS * args.clip_sec)
    for start in range(0, len(keys), args.batch):
        gkeys = keys[start : start + args.batch]
        my_keys = gkeys[pid::nproc]
        # equal local rows on every process (the all-reduce in step runs in
        # lockstep): pad with silence rows up to the widest stripe
        b_local = -(-len(gkeys) // nproc)
        data = get_input_data(my_keys, args.input_type, FS, args.clip_sec,
                              True, None, None, 2) if my_keys else {}
        file_keys = list(data.keys())
        mat = np.zeros((b_local, n_samp), np.float32)
        for i, fk in enumerate(file_keys):
            v = np.asarray(data[fk]["file_contents"], np.float32)[:n_samp]
            mat[i, : v.shape[0]] = v
        out = pipe.step(mat)
        counts = local_rows(out["per_clip"]["rain_frame_count"])
        is_rain = local_rows(out["per_clip"]["clip_is_rain"])
        frac = local_rows(out["per_clip"]["clip_rain_fraction"])
        for i, fk in enumerate(file_keys):
            rows.append({
                "file_key": fk,
                "rain_actual": data[fk].get("raining"),
                "rain_frame_count": int(counts[i]),
                "clip_is_rain": bool(is_rain[i]),
                "clip_rain_fraction": float(frac[i]),
            })
        # GLOBAL aggregates (summed over gloo), identical on every process;
        # silence-pad rows contribute zero rain frames
        agg = out["aggregates"]
        agg_totals["total_rain_frames"] += int(agg["total_rain_frames"])
        agg_totals["total_rain_clips"] += int(agg["total_rain_clips"])
        agg_totals["total_clips"] += len(gkeys)

        if args.dsd:
            from audio_processing_tools_tpu_torch.host_analysis.dsd_device import (
                dsd_minutes_device,
            )

            # all local clips' minute vectors in one batched call on the
            # device (emulator parity-tested)
            vecs_b = dsd_minutes_device(mat, FS, device=device)
            for i, fk in enumerate(file_keys):
                rows[-len(file_keys) + i]["dsd_minutes"] = (
                    vecs_b[i].tolist() if vecs_b.shape[1] else []
                )

    wall = time.time() - t0
    summary = {
        **agg_totals,
        "wall_time_sec": round(wall, 3),
        "audio_hours_per_hour": round(
            agg_totals["total_clips"] * args.clip_sec / max(wall, 1e-9), 1
        ),
        "host": pid,
    }
    print(json.dumps(summary))

    if args.out and rows:
        import pandas as pd

        df = pd.DataFrame(rows)
        out_path = args.out if nproc == 1 else f"{args.out}.host{pid}"
        df.to_parquet(out_path, index=False)
        print(f"wrote {len(df)} rows -> {out_path}", file=sys.stderr)
    if distributed:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
