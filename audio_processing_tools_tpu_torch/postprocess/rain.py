"""Convert framework rain outputs to the legacy table shapes.

Counterpart of ``audio_processing_tools_tpu/postprocess/rain.py``: produces
the reference's old-style ``(test_results_df, feature_df)`` pair from the
orchestrator's namespaced results + state DataFrames.  pandas is imported
inside the function (the card's machine has none).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

_TEST_COLS = (
    "test_count", "file_key", "rain_actual", "rain_predicted",
    "rain_drop_count", "rain_peaks_count", "rain_drop_count_mod", "frain_mean",
)
_FEAT_BASE = ("test_count", "file_key", "rain_actual", "frain_mean")
_TD_FEATURES = ("kurtosis", "crest_factor", "diff_energy")


def _col(df, name: str, default=np.nan):
    return df[name] if name in df.columns else default


def postprocess_rain(results_df, rain_states_df, params: Dict[str, Any]) -> Tuple[Any, Any]:
    """Legacy result/feature tables for the 'rain' processor."""
    import pandas as pd

    if results_df.empty:
        empty_feat = list(_FEAT_BASE) + list(_TD_FEATURES) + ["nov"]
        return (pd.DataFrame(columns=list(_TEST_COLS)),
                pd.DataFrame(columns=empty_feat))

    n = len(results_df)
    counter = np.arange(n, dtype=int)
    drops = (
        results_df["rain__rain_drop_count"]
        if "rain__rain_drop_count" in results_df.columns
        else results_df["rain__rain_drops"]
    )
    frain = results_df["rain__frain_mean"]
    actual = results_df.get("rain_actual", pd.Series([None] * n))

    if "rain__predicted" in results_df.columns:
        predicted = results_df["rain__predicted"].astype(bool)
    else:
        predicted = drops > params.get("rain_drop_min_thr", 3)

    test_results_df = pd.DataFrame({
        "test_count": counter,
        "file_key": results_df["file_key"],
        "rain_actual": actual,
        "rain_predicted": predicted.astype(bool),
        "rain_drop_count": drops,
        "rain_peaks_count": _col(results_df, "rain__rain_peaks_count"),
        "rain_drop_count_mod": _col(results_df, "rain__rain_drop_count_mod"),
        "frain_mean": frain,
    })

    feature_df = pd.DataFrame({
        "test_count": counter,
        "file_key": results_df["file_key"],
        "rain_actual": actual,
        "frain_mean": frain,
    })

    wanted = ["file_key", "nov"]
    if params.get("handle_fp") or params.get("handle_fn"):
        wanted += list(_TD_FEATURES)
    present = [c for c in wanted if c in rain_states_df.columns]

    if present:
        feature_df = feature_df.merge(
            rain_states_df[present], on="file_key", how="left"
        )
    else:
        feature_df["nov"] = np.nan
        if params.get("handle_fp") or params.get("handle_fn"):
            for c in _TD_FEATURES:
                feature_df[c] = np.nan
    return test_results_df, feature_df
