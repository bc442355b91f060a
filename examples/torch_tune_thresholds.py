"""Threshold tuning on a labeled corpus with the PyTorch port
(``grid_search_vmapped`` and the gradient fits).

Counterpart of ``examples/tune_thresholds.py``.  Reference workflow
(``edge/parameter_tuning/grid_search.py``): run the detector over labeled
test vectors once per parameter combination on a process pool.  Here the
expensive front end (prefilter, STFT, PSD tracking, flux normalization) runs
ONCE per clip and every threshold combination is scored by the decision
rule on the device (kernel K10 on the card).

The demo detunes the detector (a too-high flux threshold that misses
near-threshold rain), sweeps a 3x2 grid on the hard labeled corpus and
shows the sweep recovering the accuracy; then fits all five continuous
thresholds jointly by gradient, and the same recipe on the legacy RoE
engine.

Run: ``python examples/torch_tune_thresholds.py [--device cpu]`` (the card
by default; ~1 min on the CPU).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from audio_processing_tools_tpu_torch.tuning.grid_search import grid_search_vmapped  # noqa: E402
from audio_processing_tools_tpu_torch.utils.corpus import make_hard_corpus  # noqa: E402


def main(device: str = "cuda") -> None:
    clips, labels, kinds = make_hard_corpus(seed=17, per_class=6)
    print(f"corpus: {len(clips)} clips "
          f"({int(labels.sum())} rain / {int((~labels).sum())} not), "
          f"classes: {sorted(set(kinds))}, on {device}")

    grid = {
        "new_rain_primary_flux_min": [1.2, 1.8, 4.0],  # 4.0 = detuned
        "clip_rain_min_frames": [2, 3],
    }
    results = grid_search_vmapped(clips, labels, grid,
                                  base_params={"sample_rate": 11162}, device=device)

    print(f"\n{'flux_min':>9} {'min_frames':>11} {'accuracy':>9} "
          f"{'fp':>3} {'fn':>3}")
    for r in sorted(results, key=lambda r: -r["overall_accuracy"]):
        p = r["parameters"]
        print(f"{p['new_rain_primary_flux_min']:9.1f} "
              f"{p['clip_rain_min_frames']:11d} "
              f"{r['overall_accuracy']:9.3f} "
              f"{len(r['fp_classifications']):3d} "
              f"{len(r['fn_classifications']):3d}")

    by_combo = {
        (r["parameters"]["new_rain_primary_flux_min"],
         r["parameters"]["clip_rain_min_frames"]): r["overall_accuracy"]
        for r in results
    }
    detuned = by_combo[(4.0, 3)]
    best = max(by_combo.values())
    print(f"\ndetuned accuracy {detuned:.3f} -> best tuned {best:.3f}")
    if best < detuned + 0.1:
        raise SystemExit("the sweep should beat the detuned config")

    # --- gradient fit: all five continuous thresholds jointly, no grid ---
    from audio_processing_tools_tpu_torch.tuning.gradient import (
        gradient_tune_thresholds,
        roe_gradient_tune_thresholds,
    )

    res = gradient_tune_thresholds(
        clips, labels,
        base_params={"sample_rate": 11162, "clip_rain_min_frames": 3},
        init={"new_rain_primary_flux_min": 4.0}, device=device,
    )
    print("\ngradient fit (annealed soft relaxation + Adam, 300 steps):")
    for k, v in res["thresholds"].items():
        print(f"  {k:32s} {v:6.2f}")
    print(f"detuned accuracy {res['init_accuracy']:.3f} "
          f"-> gradient tuned {res['accuracy']:.3f}")
    if res["accuracy"] < detuned + 0.1:
        raise SystemExit("the gradient fit should beat the detuned config")

    # --- same recipe on the legacy RoE engine ---
    rng = np.random.default_rng(3)
    n = 11162 * 4
    k = np.arange(1000)
    ping = sum((1.0 / h) * np.sin(2 * np.pi * 520 * h * k / 11162)
               for h in range(1, 6))

    def harmonic_rain(drops):
        x = 0.003 * rng.standard_normal(n)
        for t0 in rng.integers(0, n - 1200, drops):
            x[t0 : t0 + 1000] += 0.6 * np.exp(-k / 80.0) * ping
        return x

    roe_clips = np.stack([
        harmonic_rain(30), harmonic_rain(18),
        0.02 * rng.standard_normal(n), 0.005 * rng.standard_normal(n),
    ]).astype(np.float32)
    roe_labels = np.array([True, True, False, False])
    roe = roe_gradient_tune_thresholds(
        roe_clips, roe_labels,
        base_params={"sample_rate": 11162, "check_duration": 4},
        init={"harmonic_threshold": [9, 8, 7, 7, 7, 7],
              "min_drop_count": 2.0, "kurtosis_thr": 8.0,
              "crest_thr": 8.0, "diff_energy_thr": 20.0},
        steps=250, lr=0.08, device=device,
    )
    print(f"\nRoE gradient fit: detuned {roe['init_accuracy']:.3f} "
          f"-> tuned {roe['accuracy']:.3f}")
    if roe["accuracy"] <= roe["init_accuracy"]:
        raise SystemExit("the RoE fit should beat its detuned start")
    print("OK")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="Threshold tuning on a labeled corpus.")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    main(ap.parse_args().device)
