"""Parquet spill / restore for results + state rows.

Counterpart of ``audio_processing_tools_tpu/framework/parquet_io.py``
(reference ``audio_processing_framework.py:378-572``): nested NumPy
payloads become lists, the 2-D ``features['normalized_mode_flux_by_mode']``
expands into per-mode columns on write and reassembles on restore.  pandas
(with its Parquet engine) is imported inside the functions that write or
read a file: the card's machine has neither.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np


def to_parquet_compatible_value(value: Any) -> Any:
    """ndarray -> list, np scalar -> Python scalar, recurse containers."""
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return to_parquet_compatible_value(dataclasses.asdict(value))
    if isinstance(value, np.ndarray):
        return value.tolist()
    if isinstance(value, np.generic):
        return value.item()
    if isinstance(value, type):
        return f"{value.__module__}.{value.__qualname__}"
    if isinstance(value, Mapping):
        return {k: to_parquet_compatible_value(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [to_parquet_compatible_value(v) for v in value]
    return value


def make_state_rows_parquet_safe(rows: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Expand ``features['normalized_mode_flux_by_mode']`` (n_modes, T) into
    ``normalized_mode_flux_by_mode_<i>`` columns; convert everything else."""
    safe_rows: List[Dict[str, Any]] = []
    for row in rows:
        safe_row = dict(row)
        for key, value in list(safe_row.items()):
            if key == "features":
                continue
            safe_row[key] = to_parquet_compatible_value(value)

        features = safe_row.get("features")
        if isinstance(features, Mapping):
            features_copy = dict(features)
            nmfbm = features_copy.pop("normalized_mode_flux_by_mode", None)
            if nmfbm is not None:
                arr = np.asarray(nmfbm)
                if arr.ndim != 2:
                    raise ValueError(
                        "features['normalized_mode_flux_by_mode'] must be 2-D "
                        f"when present; got shape {arr.shape}"
                    )
                for mode_idx in range(arr.shape[0]):
                    safe_row[f"normalized_mode_flux_by_mode_{mode_idx}"] = (
                        arr[mode_idx].tolist()
                    )
            safe_row["features"] = to_parquet_compatible_value(features_copy)
        else:
            safe_row["features"] = to_parquet_compatible_value(features)
        safe_rows.append(safe_row)
    return safe_rows


def write_parquet_chunk(rows: List[Dict[str, Any]], path: Path,
                        sort_by_file_key: bool = True) -> None:
    if not rows:
        return
    import pandas as pd

    df = pd.DataFrame(rows)
    if sort_by_file_key and not df.empty and "file_key" in df.columns:
        df = df.sort_values("file_key").reset_index(drop=True)
    df.to_parquet(path, index=False)


def flush_saved_batches(
    *, results_rows: List[Dict[str, Any]],
    states_by_processor: Dict[str, List[Dict[str, Any]]],
    save_dir: Path, save_prefix: str, flush_idx: int,
) -> Tuple[List[str], Dict[str, List[str]]]:
    """Flush accumulated rows to parquet; returns saved paths."""
    save_dir.mkdir(parents=True, exist_ok=True)
    saved_result_paths: List[str] = []
    saved_state_paths: Dict[str, List[str]] = {n: [] for n in states_by_processor}

    if results_rows:
        results_path = save_dir / f"{save_prefix}__results_part_{flush_idx:05d}.parquet"
        write_parquet_chunk(results_rows, results_path)
        saved_result_paths.append(str(results_path))

    for name, rows in states_by_processor.items():
        if not rows:
            continue
        state_path = (
            save_dir / f"{save_prefix}__state__{name}_part_{flush_idx:05d}.parquet"
        )
        write_parquet_chunk(make_state_rows_parquet_safe(rows), state_path)
        saved_state_paths[name].append(str(state_path))
    return saved_result_paths, saved_state_paths


def restore_state_df_from_parquet(path):
    """Reverse the write transform for one saved state parquet chunk."""
    import pandas as pd

    df = pd.read_parquet(path).copy()
    nmf_cols = sorted(
        [c for c in df.columns if c.startswith("normalized_mode_flux_by_mode_")],
        key=lambda c: int(c.rsplit("_", 1)[1]),
    )
    if not nmf_cols:
        return df

    restored: List[Dict[str, Any]] = []
    for _, row in df.iterrows():
        feat = dict(row["features"]) if isinstance(row.get("features"), dict) else {}
        parts = []
        valid = True
        for col in nmf_cols:
            v = row[col]
            if v is None:
                valid = False
                break
            parts.append(np.asarray(v))
        if valid:
            feat["normalized_mode_flux_by_mode"] = np.stack(parts, axis=0)
        restored.append(feat)
    df["features"] = restored
    return df.drop(columns=nmf_cols)
