"""Grid-search result analysis + DSD-emulator batch plotting.

Counterpart of ``audio_processing_tools_tpu/tuning/visualization_utils.py``
(reference ``edge/parameter_tuning/visualization_utils.py``; matplotlib in
place of plotly, figures returned for notebook and test use).  pandas and
matplotlib are imported inside the functions that need them.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, List

import numpy as np


def find_single_matching_file(directory: str, pattern: str) -> str:
    """Exactly-one glob match (reference ``visualization_utils.py:218-225``)."""
    matching = glob.glob(os.path.join(directory, pattern))
    if not matching:
        raise FileNotFoundError("Could not find results matching the pattern")
    if len(matching) > 1:
        raise FileExistsError("Found more than one file matching the pattern")
    return matching[0]


def load_results(pattern: str):
    """JSON sweep results -> DataFrame (``visualization_utils.py:14-40``)."""
    import pandas as pd

    all_results: List[Dict[str, Any]] = []
    for filename in glob.glob(pattern):
        with open(filename, "r") as f:
            result = json.load(f)
        all_results.append({
            "test_name": result.get("test_name", result.get("experiment")),
            "overall_accuracy": result["overall_accuracy"],
            "param_hash": filename.split("/")[-1].split("_")[-3],
            **result["parameters"],
            "n_tp": len(result["tp_classifications"]),
            "n_tn": len(result.get("tn_classifications",
                                   result.get("tn_classifcations", []))),
            "n_fp": len(result["fp_classifications"]),
            "n_fn": len(result["fn_classifications"]),
        })
    return pd.DataFrame(all_results)


def add_derived_metrics(result_df) -> None:
    """Truncated hash + TPR/TNR columns (``visualization_utils.py:42-64``)."""
    result_df["truncated_hash"] = result_df["param_hash"].apply(
        lambda x: f"{x[:5]}...{x[-5:]}"
    )
    result_df["true_positive_rate"] = result_df["n_tp"] / (
        result_df["n_tp"] + result_df["n_fn"]
    )
    result_df["true_negative_rate"] = result_df["n_tn"] / (
        result_df["n_tn"] + result_df["n_fp"]
    )


def visualize_performance(result_df, extra_params=None, extra_param_names=None):
    """Accuracy-per-combo scatter (``visualization_utils.py:67-133``)."""
    import matplotlib.pyplot as plt

    if extra_params and extra_param_names and len(extra_params) != len(extra_param_names):
        raise Exception(
            "if extra_param_names is provided, it must be of equal length to "
            "extra_params"
        )
    sorted_df = result_df.sort_values("overall_accuracy")
    fig, ax = plt.subplots(figsize=(11, 5))
    markers = ["o", "s", "D", "x", "h", "*"]
    for (test_name, sub), m in zip(sorted_df.groupby("test_name"), markers):
        ax.scatter(sub["truncated_hash"], sub["overall_accuracy"],
                   marker=m, s=50, label=f"{test_name} accuracy")
        if extra_params:
            for param, name in zip(extra_params, extra_param_names):
                ax.scatter(sub["truncated_hash"], sub[param], marker=m, s=30,
                           alpha=0.6, label=f"{test_name} {name}")
    ax.set_xlabel("Parameter Hash")
    ax.set_ylabel("Metric Value")
    ax.set_title("Performance of Different Algo Parameters")
    ax.legend(fontsize=7)
    ax.tick_params(axis="x", rotation=60, labelsize=6)
    fig.tight_layout()
    return fig


def plot_energy_histogram_with_classification_results(
        df, title_suffix: str, raining_condition, log: bool = True):
    """Weighted-DSD-sum histogram split by classification
    (``visualization_utils.py:134-217``)."""
    import matplotlib.pyplot as plt
    import pandas as pd

    fig, ax = plt.subplots(figsize=(9, 4))
    sel = df[raining_condition] if isinstance(raining_condition, (pd.Series, np.ndarray)) else df
    vals = sel["weighted_dsd_sum"].dropna()
    if log:
        vals = np.log10(np.maximum(vals, 1e-9))
        ax.set_xlabel("log10(weighted_dsd_sum)")
    else:
        ax.set_xlabel("weighted_dsd_sum")
    ax.hist(vals, bins=50)
    ax.set_title(f"Energy histogram {title_suffix}")
    ax.set_ylabel("count")
    fig.tight_layout()
    return fig


def run_dsd_emulator_for_keys(keys: List[str],
                              local_cache_location: str = "raw_audio_cache",
                              fs_default: int = 11162):
    """Fetch keys, run the DSD emulator, concatenate minute rows
    (``visualization_utils.py:228-292``), with the port's emulator."""
    import pandas as pd

    from audio_processing_tools_tpu_torch.host_analysis.dsd_emulator import (
        DsdProcessingEmulator,
    )
    from audio_processing_tools_tpu_torch.io.audio import pcm_to_float
    from audio_processing_tools_tpu_torch.io.fetch import get_device_raw_audio_data
    from audio_processing_tools_tpu_torch.io.mark import (
        parse_mark_audio_file,
        parse_s3_audio_key,
    )
    from audio_processing_tools_tpu_torch.transform import emulator_output_to_df

    audio_map = get_device_raw_audio_data(
        keys=keys, local_cache_location=local_cache_location,
        header_only=False, show_progress=False,
    )
    frames = []
    for key in keys:
        if key not in audio_map:
            continue
        sig, metadata = parse_mark_audio_file(audio_map[key])
        metadata = {**metadata, **parse_s3_audio_key(key)}
        emu = DsdProcessingEmulator(metadata["sample_rate"], 512, 512, False, 0)
        out = emu.process_audio_data(pcm_to_float(sig), ts=0)
        df = emulator_output_to_df(out, metadata["device_id"], metadata["time"])
        df["key"] = key
        frames.append(df)
    return pd.concat(frames, ignore_index=True) if frames else pd.DataFrame()


# name parity with the reference (``visualization_utils.py:228``)
process_audio_data_through_dsd_emulator = run_dsd_emulator_for_keys
