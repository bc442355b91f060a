#!/usr/bin/env python3
"""Device time of the peak-shape stages, K11-K13 (``csrc/peak_shape.cu``:
``local_maxima``, ``peak_prominences``, ``peak_widths_rel``), at the shapes
of the three paths that call them, and of those paths' stages.

    python3 tools/time_peaks.py [--root DIR] [--out FILE]

Shapes: the inputs ``chip_smoke.peak_path_rows`` captures from
``chip_smoke.py``'s 128 x 10 s clips: RoE's spectral peaks (640 x 175,
129) and novelty rows (640, 176), the confirmer's windows of clip 1 (871,
384) and the peak gate's detector dB (128, 873, 71).  At each: the ms of
the function the path calls (``ops/peaks.py``: the kernel on a checkout
that has it, the plain version on an older one) from CUDA events around
host-launched calls, in turns with the plain version where the checkout
has one (plain, path, path, plain), and the kernel's device ms from a
CUDA graph of 20 (``chip_smoke.graph_ms``) where it has the kernel; the
kernels' results against the plain versions, bit for bit (K12's zeros by
value), else it exits non-zero; on a checkout with K11's and K12's routes,
each route's graph ms at each of their inputs, as passed and in the other
layout (``chip_smoke.other_layout``), and K13's where it has routes
(``width_route``), there also on the gate's rows extended to 129, 176
and 256 positions in both layouts and to 384, 1,025 and 2,048 as
contiguous rows, every local maximum a peak.  Stages: the peak gate
(``models/frame_classifier.py::_peak_gate`` over the 128 clips' dB; CUDA
events, and its kernels' device time from torch.profiler), the
confirmer's ``TimeDomainRainDetector.process`` on clip 1 (host clock and
CUDA kernels) and RoE's ``_roe_batch`` (CUDA events and device time),
each with the peak memory above its start.  ``--root`` imports the port from another
checkout (the parent: ``git archive <parent> | tar -x -C build/parent``),
so that two trees are compared on one card, one process each; the inputs
and the timing helpers always come from this checkout's ``chip_smoke.py``.
Prints the card's name and power limit, then one JSON line.  Needs a CUDA
card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from time_k6_k7 import smi_query
from time_k9 import load_chip_smoke

REPO = Path(__file__).resolve().parent.parent

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--out", default=None, help="also write the JSON line to this file")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_peaks: no CUDA device", file=sys.stderr)
        return 1
    # the port from --root first: chip_smoke.py puts its own checkout first on the path
    from audio_processing_tools_tpu_torch.config import build_noise_config
    from audio_processing_tools_tpu_torch.models import frame_classifier as fc
    from audio_processing_tools_tpu_torch.models import roe
    from audio_processing_tools_tpu_torch.models import time_domain as ttd
    from audio_processing_tools_tpu_torch.ops import peaks as tpk

    chip_smoke = load_chip_smoke()
    peak_mem = chip_smoke.peak_mem
    smi = smi_query("name,power.limit")
    print(smi)
    dev = torch.device("cuda", 0)
    result = {"root": args.root, "package": str(Path(tpk.__file__).resolve().parent.parent),
              "card": smi, "kernels": hasattr(tpk, "_local_maxima_cuda"), "shapes": {},
              "stages": {}}
    print(f"the port from {result['package']}; K11-K13 "
          f"{'present' if result['kernels'] else 'absent'}")
    x = torch.from_numpy(chip_smoke.synth_clips()[0]).to(dev)
    rows = chip_smoke.peak_path_rows(x)

    def events(fn, n=10):
        return float(np.median(chip_smoke.cuda_times(fn, n)))

    for label, (kernel, fargs) in rows.items():
        path = getattr(tpk, kernel)
        rec = {"kernel": chip_smoke.PEAK_KERNELS[kernel], "shape": list(fargs[0].shape)}
        if result["kernels"]:
            chip_smoke.peak_holds(kernel, fargs, label)
            plain = getattr(tpk, f"_{kernel}_plain")
            p1, c1, c2, p2 = (events(lambda f=f: f(*fargs), n)
                              for f, n in ((plain, 3), (path, 10), (path, 10), (plain, 3)))
            rec.update({"call_ms": (c1 + c2) / 2, "plain_ms": (p1 + p2) / 2,
                        "graph_ms": chip_smoke.graph_ms(
                            lambda: getattr(tpk, f"_{kernel}_cuda")(*fargs))})
        else:
            rec["call_ms"] = events(lambda: path(*fargs), 3)
        _, rec["peak_mib"] = peak_mem(lambda: path(*fargs))
        result["shapes"][label] = rec
        print(f"{rec['kernel']} {label} {tuple(fargs[0].shape)}: {rec}")

    # every route of K11-K13 at each path's input, in its layout and the other
    if hasattr(tpk, "prominence_route"):
        result["routes"] = {}
        for label, (kernel, fargs) in rows.items():
            if kernel == "peak_widths_rel" and not hasattr(tpk, "width_route"):
                continue
            cuda = getattr(tpk, f"_{kernel}_cuda")
            for how, a in (("as passed", fargs),
                           ("other layout", tuple(chip_smoke.other_layout(t) for t in fargs))):
                rec = {route: chip_smoke.graph_ms(lambda r=route: cuda(*a, route=r))
                       for route in chip_smoke.peak_routes(kernel, a[0])}
                key = f"{label}, {how} ({tpk.peak_layout(a[0])})"
                result["routes"][key] = rec
                print(f"routes {key}: {rec}")

    # K13's routes on wider rows: the gate's dB rows extended to n positions
    # (itself, mirrored, and again), every local maximum a peak, its
    # prominences from K12, rel_height 0.5; each route against the walk bit
    # for bit
    if hasattr(tpk, "width_route"):
        result["k13_widths"] = {}
        sT = rows["the peak gate peak_widths_rel"][1][0]
        for n in (71, 129, 176, 256, 384, 1025, 2048):
            xw = torch.cat([sT, sT.flip(-1)] * -(-n // (2 * sT.shape[-1])), -1)[..., :n]
            xw = xw.contiguous()
            mask = tpk._local_maxima_cuda(xw, route="warp")
            rowwise = (xw, mask, tpk._peak_prominences_cuda(xw, mask), 0.5)
            layouts = [("rows", rowwise)]
            if n <= 256:
                layouts.append(("columns", tuple(chip_smoke.other_layout(t) for t in rowwise)))
            for how, fargs in layouts:
                a = fargs[0]
                routes = chip_smoke.peak_routes("peak_widths_rel", a)
                ref = tpk._peak_widths_rel_cuda(*fargs, route="walk")
                for route in routes:
                    ok, _ = chip_smoke.same_bits(
                        tpk._peak_widths_rel_cuda(*fargs, route=route), ref)
                    chip_smoke.check(ok, f"K13 at {n} {how}: the {route} route's bits differ")
                rec = {route: chip_smoke.graph_ms(
                           lambda r=route: tpk._peak_widths_rel_cuda(*fargs, route=r))
                       for route in routes}
                rec["chosen"] = tpk.width_route(n, tpk.peak_layout(a))
                result["k13_widths"][f"{n} {how}"] = rec
                print(f"K13 {tuple(a.shape)} {how}, every maximum: {rec}")
            del xw, a, mask, rowwise, layouts, fargs, ref
            torch.cuda.empty_cache()

    # the stages as the paths run them
    cfg = build_noise_config(chip_smoke.FS, chip_smoke.PEAK_GATE)
    geo = fc.BandGeometry(cfg)
    spec = rows["the peak gate local_maxima"][1][0].transpose(-1, -2)  # (128, 71, 873)
    gate = lambda: fc._frame_peak_gate(cfg, geo, spec)  # noqa: E731
    _, mib = peak_mem(gate)
    n_kern, busy, top = chip_smoke.device_kernels(gate)
    result["stages"]["peak gate, 128 x 10 s"] = {"ms": events(gate, 5), "peak_mib": mib,
                                                 "cuda_kernels": n_kern, "busy_ms": busy,
                                                 "costliest": top}
    det = ttd.TimeDomainRainDetector(ttd.build_time_domain_config(chip_smoke.PARAMS), device=dev)
    clip = x[1].cpu().numpy()
    det.process(clip)
    _, mib = peak_mem(lambda: det.process(clip))
    host = []
    for _ in range(10):
        t0 = time.perf_counter()
        det.process(clip)
        host.append((time.perf_counter() - t0) * 1e3)
    n_kern, busy, _ = chip_smoke.device_kernels(lambda: det.process(clip))
    result["stages"]["confirmer, a clip"] = {"host_ms": float(np.median(host)), "peak_mib": mib,
                                             "cuda_kernels": n_kern, "busy_ms": busy}
    roe_cfg = roe.build_roe_config(return_spectra=False)
    _, mib = peak_mem(lambda: roe._roe_batch(x, roe_cfg))
    n_kern, busy, _ = chip_smoke.device_kernels(lambda: roe._roe_batch(x, roe_cfg))
    result["stages"]["RoE, 128 x 10 s"] = {"ms": events(lambda: roe._roe_batch(x, roe_cfg), 10),
                                           "peak_mib": mib, "cuda_kernels": n_kern,
                                           "busy_ms": busy}
    for label, rec in result["stages"].items():
        print(f"{label}: {rec}")
    line = json.dumps(result)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
