#!/usr/bin/env python3
"""Device time of K1's chirp-z route at each candidate transform size, for
geometries whose complex length has a prime factor above 31, against
``stft_power``.

    python3 tools/time_chirp_sizes.py [--geometries 296/148 1009/504 ...] [--tiles] [--sizes M ...]
                                      [--csrc DIR] [--out FILE]
    python3 tools/time_chirp_sizes.py --split [--geometries 9999/4999 ...] [--out FILE]

On chip_smoke's 128 synthetic 10 s clips: for each geometry, the chirp-z
launcher (the global route's past one block) is called over the 7-smooth
sizes M from L + K - 1 (K the bins the power reads,
``ops/spectrogram.py::chirp_bins``) up to 4L whose block fits: the
smallest, every one with the fewest passes, the three smallest with one
pass more, and the size of the rule before the bins were pruned (from 2L
- 1) (``ops/spectrogram.py::chirp_size`` picks the fewest passes, then the
smallest size), with the tables ``chirpz_tables(n_fft, M)``, at the frame
tile of ``ops/spectrogram.py::chirpz_launch_plan``; with ``--tiles`` the
one-block sizes with the fewest passes also at every frame tile whose
block fits; ``--sizes`` times only the sizes given; ``--csrc`` builds the
kernels from another source directory (a variant of ``csrc/`` kept under
``build/``, so that two versions of a kernel are timed one process each,
in turns).  Each output is
held within 1e-5 of ``stft_power``'s maximum and its device ms per call
taken from a CUDA graph of 20 calls (``chip_smoke.graph_ms``), the sizes in
turns (forward, then backward, the mean of both).  Prints the card's name
and power limit, a line per geometry, then one JSON line.  Needs a CUDA
card; imports nothing of JAX.

``--split`` times K1's route for each geometry instead (by default
9,999/4,999, 14,530/7,265, 7,005/3,502 and 14,010/7,005, on the split
route, and 7,013/3,506, 7,003/3,501, 7,396/3,698, 10,821/5,410,
30,011/15,005 and 40,009/20,004 on the cluster route, clusters of 1, 1, 1,
2, 4 and 8 blocks): the route, for the split route also at each other
column tile whose block fits a third of the shared memory (``split_plan``
patched within this tool) and the cluster route forced, for the cluster route
also at each other cluster size that holds the transform (``cluster_plan``
patched within this tool); the chirp-z
global route it replaced, forced; and ``stft_power``; each output held within
1e-5 of ``stft_power``'s maximum, all in turns as above; and the route's
device ms per launch of each CUDA kernel (``chip_smoke.launch_breakdown``,
torch.profiler), for the split route also per call: per launch times its
chunks, one launch of each kernel a chunk.  The cluster route is one
launch, its columns, exchanges and rows inside one kernel, which the
profiler times as a whole; its registers and spills (ptxas) and the
clusters the card holds at once (``cudaOccupancyMaxActiveClusters``) are
printed beside it.
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
    ap.add_argument("--geometries", nargs="+", default=None)
    ap.add_argument("--split", action="store_true",
                    help="time K1's route (the split route's column tiles, the global route "
                         "forced) and stft_power instead of the chirp-z sizes")
    ap.add_argument("--tiles", action="store_true",
                    help="also time the fewest-pass sizes at every frame tile")
    ap.add_argument("--sizes", nargs="+", type=int, default=None,
                    help="time only these transform sizes")
    ap.add_argument("--csrc", default=None, help="build the kernels from this source directory")
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
    if args.csrc:
        _kernels.CSRC = Path(args.csrc).resolve()
    lib = _kernels.build()
    dev = torch.device("cuda", 0)
    x = torch.from_numpy(cs.synth_clips()[0]).to(dev)
    B, N = x.shape
    if args.split:
        return time_routes(args, smi, x)
    result = {"card": smi, "csrc": str(_kernels.CSRC), "chosen": {}, "ms": {},
              "stft_power_ms": {}}
    for geo in args.geometries or ["296/148", "1009/504", "1031/515", "2062/1031"]:
        n_fft, hop = (int(v) for v in geo.split("/"))
        L, K = (n_fft // 2 if n_fft % 2 == 0 else n_fft), tspec.chirp_bins(n_fft)
        one_block = L + K - 1 <= tspec.ONE_BLOCK_POINTS

        def fits(m):
            return tspec.tile_plan(m) is not None if one_block else (
                tspec.four_step_plan(m) is not None)

        sizes = [m for m in tspec._seven_smooth_between(max(2, L + K - 1), 4 * L) if fits(m)]
        fewest = min(len(tspec.mixed_radices(m)) for m in sizes)
        sizes = sorted({m for m in sizes if len(tspec.mixed_radices(m)) == fewest}
                       | set([m for m in sizes if len(tspec.mixed_radices(m)) == fewest + 1][:3])
                       | {min(sizes), tspec.chirp_size(L)})
        if args.sizes:
            sizes = [m for m in args.sizes if m >= L + K - 1 and fits(m)]
        runs = [(m, tspec.chirpz_launch_plan(m).frame_tile if one_block else 0) for m in sizes]
        if args.tiles and one_block:
            runs += [(m, ft) for m in sizes if len(tspec.mixed_radices(m)) == fewest
                     for ft in (1, 2, 4, 8, 16, 32)
                     if ft != tspec.chirpz_launch_plan(m).frame_tile
                     and 16 * tspec.tile_elems(m, ft) <= tspec.SMEM_LIMIT]
        win, tw = (torch.from_numpy(a).to(dev).contiguous()
                   for a in tspec.kernel_tables(n_fft))
        T = 1 + N // hop
        out = torch.empty((B, n_fft // 2 + 1, T), device=dev)
        ref = stft_power(x, n_fft=n_fft, hop=hop)
        calls = {}
        for M, ft in runs:
            tabs = [torch.from_numpy(a).to(dev).contiguous()
                    for a in tspec.chirpz_tables(n_fft, M)]
            ptrs = [t.data_ptr() for t in tabs]
            if one_block:
                smem = 16 * tspec.tile_elems(M, ft)

                def call(M=M, ft=ft, smem=smem, ptrs=ptrs):
                    lib.check(lib.lib.apt_spectrogram_power_chirpz(
                        x.data_ptr(), win.data_ptr(), tw.data_ptr(), *ptrs, out.data_ptr(), B,
                        N, T, n_fft, hop, n_fft // 2, M, ft, smem, _kernels.stream_of(x)),
                        "spectrogram_power")
            else:
                scratch = torch.empty(4 * M * tspec.chunk_frames(M, B * T), device=dev)

                def call(M=M, ptrs=ptrs, scratch=scratch):
                    lib.check(lib.lib.apt_spectrogram_power_global(
                        x.data_ptr(), win.data_ptr(), tw.data_ptr(), *ptrs, out.data_ptr(), B,
                        N, T, n_fft, hop, n_fft // 2, M, scratch.data_ptr(),
                        4 * scratch.numel(), _kernels.stream_of(x)), "spectrogram_power")

            call()
            torch.cuda.synchronize()
            d = float((out - ref).abs().max())
            if d > 1e-5 * float(ref.abs().max()):
                raise SystemExit(f"K1 chirp-z {n_fft}/{hop} over {M}, tile {ft}: max|d| {d:.3e}")
            calls[(M, ft)] = call
        ms = {k: [] for k in calls}
        for k in list(calls) + list(calls)[::-1]:
            ms[k].append(cs.graph_ms(calls[k]))
        ms = {k: float(np.mean(v)) for k, v in ms.items()}
        lib_ms = cs.graph_ms(lambda: stft_power(x, n_fft=n_fft, hop=hop))
        chosen = tspec.fft_shape(n_fft)[1]
        result["chosen"][geo] = chosen
        result["ms"][geo] = {f"{M}/{ft}": v for (M, ft), v in ms.items()}
        result["stft_power_ms"][geo] = lib_ms
        print(f"{geo} (L {L}, K {K}, chosen {chosen}): stft_power {lib_ms:.4f} ms; "
              + ", ".join(f"{M} ({'x'.join(map(str, tspec.mixed_radices(M)))}"
                          + (f", tile {ft}" if ft else "") + f") {v:.4f}"
                          for (M, ft), v in ms.items()))
    line = json.dumps(result)
    print(line)
    if args.out:
        Path(args.out).write_text(line + "\n")
    return 0


def time_routes(args, smi: str, x) -> int:
    """``--split``: each geometry's route and the routes it replaced, in
    turns against ``stft_power``."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from audio_processing_tools_tpu_torch.ops import spectrogram as tspec
    from audio_processing_tools_tpu_torch.ops.stft import stft_power

    from audio_processing_tools_tpu_torch import _kernels

    geos = args.geometries or ["9999/4999", "14530/7265", "7005/3502", "14010/7005",
                               "7013/3506", "7003/3501", "7396/3698", "10821/5410",
                               "30011/15005", "40009/20004"]
    result = {"card": smi, "route": {}, "split": {}, "cluster": {}, "ms": {}, "max_rel": {},
              "launches_ms": {}, "chunks": {}, "calls_ms": {}, "ptxas": cluster_ptxas(
                  _kernels.build().build_log)}
    print("ptxas, the cluster route's kernels: " + "; ".join(result["ptxas"]))
    for geo in geos:
        n_fft, hop = (int(v) for v in geo.split("/"))
        L = n_fft // 2 if n_fft % 2 == 0 else n_fft
        route = tspec.k1_route(n_fft, hop)

        def forced(r, **kw):
            return lambda: tspec._spectrogram_power_cuda(x, n_fft, hop, True, "hann", r, **kw)

        calls = {route: forced(route)}
        if route == "split":
            sp = tspec.split_plan(L)
            result["split"][geo] = sp._asdict()
            for ft in (1, 2, 4, 8, 16, 32):
                smem = 16 * tspec.tile_elems(sp.M, ft) + (16 * ft if sp.kind == "rader" else 0)
                if ft != sp.col.frame_tile and smem <= tspec.SMEM_LIMIT // 3:
                    calls[f"split, tile {ft}"] = with_plan(
                        forced("split"), "split_plan",
                        lambda L, p=sp._replace(col=tspec.LaunchPlan(ft, smem)): p)
            calls["global"] = forced("global")
        cp = tspec.cluster_plan(L, tspec.chirp_bins(n_fft))
        if cp is not None and route in ("split", "cluster"):
            result["cluster"][geo] = {**cp._asdict(),
                                      "max_active": tspec.cluster_max_active(cp.C, cp.smem_bytes)}
            calls.setdefault("cluster", forced("cluster"))
        if route == "cluster":
            for c in tspec.CLUSTER_SIZES:
                if c != cp.C and tspec.cluster_plan(L, tspec.chirp_bins(n_fft), c) is not None:
                    calls[f"cluster of {c}"] = with_plan(
                        forced("cluster"), "cluster_plan",
                        lambda L, K=None, C=None, c=c, kept=tspec.cluster_plan: kept(L, K, c))
            calls["global"] = forced("global")
        calls["stft_power"] = lambda: stft_power(x, n_fft=n_fft, hop=hop)
        ref = calls["stft_power"]()
        top = float(ref.abs().max())
        rel = {}
        for k, call in calls.items():
            got = call()
            torch.cuda.synchronize()
            rel[k] = float((got - ref).abs().max()) / top
            if rel[k] > 1e-5:
                raise SystemExit(f"K1 {geo} {k}: max|d|/max {rel[k]:.3e} (bound 1e-5)")
            del got
        ms = {k: [] for k in calls}
        for k in list(calls) + list(calls)[::-1]:
            ms[k].append(cs.graph_ms(calls[k]))
        ms = {k: float(np.mean(v)) for k, v in ms.items()}
        result["route"][geo] = route
        result["ms"][geo] = ms
        result["max_rel"][geo] = rel
        per_launch = cs.launch_breakdown(calls[route], calls=5)
        result["launches_ms"][geo] = per_launch
        per_call = ""
        if route == "split":
            frames = ref.numel() // (n_fft // 2 + 1)
            chunks = -(-frames // tspec.chunk_frames(tspec.split_frame_points(n_fft), frames))
            result["chunks"][geo] = chunks
            result["calls_ms"][geo] = {k: round(v * chunks, 4) for k, v in per_launch.items()}
            per_call = f"; {chunks} chunks, per call {result['calls_ms'][geo]}"
        cl = result["cluster"].get(geo)
        print(f"{geo} (L {L}, route {route}"
              + (f", {sp.P} x {sp.Q} by {sp.kind} over {sp.M}, tile {sp.col.frame_tile}"
                 if route == "split" else "")
              + (f"; cluster of {cl['C']} over {cl['M']} = {cl['N1']} x {cl['N2']}, "
                 f"{cl['smem_bytes']} bytes a block, {cl['max_active']} clusters at once"
                 if cl else "") + "): "
              + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()) + " ms; per launch "
              + str(per_launch) + per_call)
    line = json.dumps(result)
    print(line)
    if args.out:
        Path(args.out).write_text(line + "\n")
    return 0


def cluster_ptxas(log: str):
    """ptxas's lines (registers, spills) for the cluster route's kernels in
    the build log."""
    out, take = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            take = "spectrogram_power_cluster" in line
            if take:
                out.append(line.split("'")[1] if "'" in line else line.strip())
        elif take and ("registers" in line or "spill" in line):
            out.append(line.split(":", 1)[-1].strip())
    return out


def with_plan(call, name, plan):
    """``call`` with the planner ``name`` of ``ops/spectrogram.py`` replaced
    by ``plan`` while it runs (another split column tile, another cluster
    size)."""
    from audio_processing_tools_tpu_torch.ops import spectrogram as tspec

    def run():
        kept = getattr(tspec, name)
        setattr(tspec, name, plan)
        try:
            return call()
        finally:
            setattr(tspec, name, kept)

    return run


if __name__ == "__main__":
    sys.exit(main())
