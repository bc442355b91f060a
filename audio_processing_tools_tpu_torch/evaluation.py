"""Labeled-corpus accuracy harness: FP/FN splits and CSV reports.

Counterpart of ``audio_processing_tools_tpu/evaluation.py``.  The
reference's real test strategy (SURVEY §4) is corpus accuracy: run a
classifier over labeled test vectors, split confusion classes, and persist
``results_fp.csv`` / ``results_fn.csv`` / ``test_results.csv``
(``edge/dsp_rain_detection.py:3248-3282``).  This module provides that
harness over the framework's results DataFrame (pandas-typed input; the
module itself imports no pandas).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional


def confusion_split(results_df, predicted_col: str,
                    actual_col: str = "rain_actual") -> Dict[str, Any]:
    """Split a results DataFrame into tp/tn/fp/fn sub-frames."""
    pred = results_df[predicted_col].astype(bool)
    actual = results_df[actual_col].astype(bool)
    return {
        "tp": results_df[pred & actual],
        "tn": results_df[~pred & ~actual],
        "fp": results_df[pred & ~actual],
        "fn": results_df[~pred & actual],
    }


def evaluate_corpus(
    results_df,
    *,
    predicted_col: str = "rain_detector__clip_is_rain",
    actual_col: str = "rain_actual",
    out_dir: Optional[str] = None,
    prefix: str = "results",
) -> Dict[str, Any]:
    """Accuracy + confusion stats; optional reference-shaped CSV outputs.

    Writes ``<prefix>_fp.csv``, ``<prefix>_fn.csv`` and ``test_results.csv``
    into ``out_dir`` when given (parity with the legacy ``main()`` harness).
    """
    if results_df.empty:
        return {"n": 0, "accuracy": float("nan")}

    split = confusion_split(results_df, predicted_col, actual_col)
    n = len(results_df)
    n_fp, n_fn = len(split["fp"]), len(split["fn"])
    stats: Dict[str, Any] = {
        "n": n,
        "n_tp": len(split["tp"]),
        "n_tn": len(split["tn"]),
        "n_fp": n_fp,
        "n_fn": n_fn,
        "accuracy": 1.0 - (n_fp + n_fn) / n,
        "true_positive_rate": (
            len(split["tp"]) / max(len(split["tp"]) + n_fn, 1)
        ),
        "true_negative_rate": (
            len(split["tn"]) / max(len(split["tn"]) + n_fp, 1)
        ),
    }

    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        split["fp"].to_csv(os.path.join(out_dir, f"{prefix}_fp.csv"), index=False)
        split["fn"].to_csv(os.path.join(out_dir, f"{prefix}_fn.csv"), index=False)
        results_df.to_csv(os.path.join(out_dir, "test_results.csv"), index=False)
    return stats
