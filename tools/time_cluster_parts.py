#!/usr/bin/env python3
"""Where K1's cluster route spends its time: the route against copies of
its kernel with one part taken out, in turns, on the card.

    python3 tools/time_cluster_parts.py [--geometries 7013/3506 ...] [--out FILE]

The cluster route is one launch (``csrc/spectrogram_cluster.cu``), so the
profiler sees its columns, exchanges and rows only as one kernel.  This
tool copies ``csrc/`` into ``build/cluster_parts/<variant>/csrc`` once per
variant, with one edit each, builds every copy at once (one library each),
and times the route through each on ``chip_smoke.py``'s 128 synthetic 10 s
clips, device ms per call from a CUDA graph of 20 calls
(``chip_smoke.graph_ms``), the variants in turns (forward, then backward,
the mean of both):

* ``route``: the kernel as it is, its output held within 1e-5 of
  ``stft_power``'s maximum;
* ``no load``: the columns read zeros, not the clip (the samples, window
  and chirp loads skipped);
* ``no exchange``: the two exchanges copy nothing (their cluster barriers
  kept; a cluster of one has none);
* ``no twiddle``: the four-step twiddles skipped;
* ``no Bt``: the product by Bt skipped;
* ``768 threads``: the block at 768 threads, not 512 (its output held
  like the route's).

The parts' outputs are wrong by design and not checked: a part's cost is the
route's time less its variant's.  Prints the card's name and power limit, a
line per geometry, then one JSON line.  Needs a CUDA card; imports nothing
of JAX.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
CSRC = REPO / "audio_processing_tools_tpu_torch" / "csrc"
# variant: (file, text, replacement), the text found exactly once
EDITS = {
    "route": None,
    "no load": ("spectrogram_cluster.cu", "        if (n < L) {\n          v = even",
                "        if (n < 0) {\n          v = even"),
    "no exchange": ("cluster_fft.cuh", "      s.nr * s.N2,\n", "      0,\n"),
    "no twiddle": ("cluster_fft.cuh", "if (k > 0 && g > 0) v = cmul(v, tabs.four_step(k * g));",
                   ""),
    "no Bt": ("cluster_fft.cuh", "      v = cmul(v, __ldg(bt + g + kstride * k));\n", ""),
    "768 threads": ("cluster_fft.cuh", "constexpr int kClusterThreads = 512;",
                    "constexpr int kClusterThreads = 768;"),
}
CHECKED = ("route", "768 threads")


def make_variants(root: Path) -> dict:
    """The variants' source directories under ``root``."""
    dirs = {}
    for name, edit in EDITS.items():
        d = root / name.replace(" ", "_") / "csrc"
        if d.parent.exists():
            shutil.rmtree(d.parent)
        shutil.copytree(CSRC, d)
        edits = [edit] if edit else []
        if name == "no exchange":  # both exchanges
            edits.append(("cluster_fft.cuh", "      s.N1 * s.nc,\n", "      0,\n"))
        for fname, text, repl in edits:
            p = d / fname
            src = p.read_text()
            if src.count(text) != 1:
                raise SystemExit(f"{name}: the edit's text is not in {fname} once")
            p.write_text(src.replace(text, repl))
        dirs[name] = d
    return dirs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--geometries", nargs="+",
                    default=["7013/3506", "10821/5410", "30011/15005", "40009/20004"])
    ap.add_argument("--out", default=None, help="also write the JSON line to this file")
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_cluster_parts: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from audio_processing_tools_tpu_torch import _kernels
    from audio_processing_tools_tpu_torch.ops import spectrogram as tspec
    from audio_processing_tools_tpu_torch.ops.stft import stft_power

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)
    dirs = make_variants(REPO / "build" / "cluster_parts")
    builds = [subprocess.Popen([sys.executable, "-c", (
        "import sys; from pathlib import Path; sys.path.insert(0, sys.argv[1]); "
        "from audio_processing_tools_tpu_torch import _kernels; "
        "_kernels.CSRC = Path(sys.argv[2]); _kernels.build()"), str(REPO), str(d)])
        for d in dirs.values()]
    if any(p.wait() != 0 for p in builds):
        raise SystemExit("a variant did not build")
    libs = {}
    for name, d in dirs.items():
        _kernels._LIBRARY = None
        _kernels.CSRC = d
        libs[name] = _kernels.build()
    x = torch.from_numpy(cs.synth_clips()[0]).to(torch.device("cuda", 0))
    names = list(EDITS)
    result = {"card": smi, "ms": {}, "part_ms": {}, "max_rel": {}}
    for geo in args.geometries:
        n_fft, hop = (int(v) for v in geo.split("/"))

        def call(name, n_fft=n_fft, hop=hop):
            def run():
                _kernels._LIBRARY = libs[name]
                return tspec._spectrogram_power_cuda(x, n_fft, hop, True, "hann", "cluster")
            return run

        ref = stft_power(x, n_fft=n_fft, hop=hop)
        top = float(ref.abs().max())
        rel = {}
        for name in CHECKED:
            got = call(name)()
            torch.cuda.synchronize()
            rel[name] = float((got - ref).abs().max()) / top
            if rel[name] > 1e-5:
                raise SystemExit(f"K1 {geo} {name}: max|d|/max {rel[name]:.3e} (bound 1e-5)")
            del got
        ms = {k: [] for k in names}
        for k in names + names[::-1]:
            ms[k].append(cs.graph_ms(call(k)))
        ms = {k: float(np.mean(v)) for k, v in ms.items()}
        parts = {k: ms["route"] - ms[k] for k in names if k.startswith("no ")}
        result["ms"][geo], result["part_ms"][geo], result["max_rel"][geo] = ms, parts, rel
        plan = tspec.cluster_plan(n_fft // 2 if n_fft % 2 == 0 else n_fft, tspec.chirp_bins(n_fft))
        print(f"{geo} (a cluster of {plan.C} over {plan.N1} x {plan.N2}): "
              + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()) + " ms; parts "
              + ", ".join(f"{k[3:]} {v:.4f}" for k, v in parts.items()))
    line = json.dumps(result)
    print(line)
    if args.out:
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
