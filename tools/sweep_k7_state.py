#!/usr/bin/env python3
"""The sweep that sets K7's state dtype rule (``ops/filters.py::
k7_state_dtype``): for Butterworth designs at 11,162 Hz, the noise gain of
the cascade's states (``k7_noise_gain`` summed over the sections) and the
error of K7's plain loop with a float32 state against scipy's float64
``sosfilt`` of the same constants.

    python3 tools/sweep_k7_state.py [--samples 4000] [--seeds 0] [--out FILE]

Designs: high-passes at 40-400 Hz of orders 2-16, band-passes 400-3,500,
100-3,500, 60-3,000, 200-2,000, 1,000-1,200 and 300-400 Hz of orders 1-4,
low-passes at 1, 3 and 5 kHz of orders 4, 8 and 16 (at most 8 sections
each).  For each seed, 3 rows of 0.1 x white noise from a nonzero state;
the error is the larger of y's and zf's max|d| over their maxima, the worst
over the seeds.  Prints one line a design, sorted by gain, marked with the
state dtype the rule gives, then a summary and one JSON line.  Runs on the
CPU; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
FS = 11162


def designs():
    from audio_processing_tools_tpu_torch.ops import filters as tfl

    out = {}
    for fc in (40, 50, 60, 70, 80, 90, 100, 120, 150, 200, 250, 300, 350, 400):
        for order in (2, 4, 6, 8, 10, 12, 14, 15, 16):
            out[f"hp {fc} o{order}"] = tfl.design_highpass(FS, fc, order)
    for lo, hi in ((400, 3500), (100, 3500), (60, 3000), (200, 2000), (1000, 1200), (300, 400)):
        for order in (1, 2, 3, 4):
            out[f"bp {lo}-{hi} o{order}"] = tfl.design_bandpass(FS, lo, hi, order)
    for fc in (1000, 3000, 5000):
        for order in (4, 8, 16):
            out[f"lp {fc} o{order}"] = tfl.butter_sos(order, fc / (0.5 * FS), "lowpass")
    return out


def float32_error(sos, samples: int, seed: int) -> float:
    """K7's plain loop with a float32 state against scipy float64 on JAX's
    float32 constants: max over y and zf of max|d| / max."""
    import numpy as np
    import torch
    from scipy import signal

    from audio_processing_tools_tpu_torch.ops import filters as tfl

    S = sos.shape[0]
    rng = np.random.default_rng(seed)
    x = (0.1 * rng.standard_normal((3, samples))).astype(np.float32)
    zi = 0.01 * rng.standard_normal((3, S, 2))
    coef = tfl._sos_coefficients(sos)
    y, zf = tfl._sosfilt_zi_plain(torch.from_numpy(coef), torch.from_numpy(x),
                                  torch.from_numpy(zi).float())
    b0, bv0, bv1, a1, a2 = coef.astype(np.float64).T
    same = np.stack([b0, bv0 + a1 * b0, bv1 + a2 * b0, np.ones(S), a1, a2], axis=1)
    ref, zref = signal.sosfilt(same, x.astype(np.float64), axis=-1, zi=zi.transpose(1, 0, 2))
    ey = np.abs(y.numpy() - ref).max() / np.abs(ref).max()
    ez = np.abs(zf.double().numpy() - zref.transpose(1, 0, 2)).max() / np.abs(zref).max()
    return float(max(ey, ez))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--samples", type=int, default=4000)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--out", default=None, help="also write the JSON line to this file")
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))

    import torch

    from audio_processing_tools_tpu_torch.ops import filters as tfl

    torch.set_num_threads(1)
    rows = []
    for name, sos in designs().items():
        gain = sum(tfl.k7_noise_gain(a1, a2) for a1, a2 in sos[:, 4:6] / sos[:, 3:4])
        err = max(float32_error(sos, args.samples, s) for s in args.seeds)
        rows.append((gain, err, name, str(tfl.k7_state_dtype(sos)).removeprefix("torch.")))
    rows.sort()
    for gain, err, name, dtype in rows:
        print(f"{name:22s} gain {gain:9.1f}  float32 error {err:.2e}  -> {dtype}")
    kept = [r for r in rows if r[3] == "float32"]
    moved = [r for r in rows if r[3] == "float64"]
    summary = {"designs": len(rows), "samples": args.samples, "seeds": args.seeds,
               "threshold": tfl.K7_FLOAT32_MAX_GAIN,
               "float32_designs": len(kept), "worst_float32_error_kept": max(r[1] for r in kept),
               "float64_designs": len(moved),
               "least_gain_above_1e-5": min((r[0] for r in rows if r[1] > 1e-5), default=None)}
    print(f"{len(kept)} designs keep float32 (worst error {summary['worst_float32_error_kept']:.2e}); "
          f"{len(moved)} take float64; the least gain whose float32 error passes 1e-5: "
          f"{summary['least_gain_above_1e-5']}")
    line = json.dumps(summary)
    print(line)
    if args.out:
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
