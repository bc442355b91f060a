"""Per-file noise summary.

Counterpart of ``audio_processing_tools_tpu/postprocess/noise.py``; pandas
is imported inside the function.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np


def postprocess_noise(results_df, noise_states_df, params: Dict[str, Any]):
    import pandas as pd

    if results_df.empty:
        return pd.DataFrame(
            columns=["file_key", "rain_actual", "noise_snr_db", "noise_floor_db"]
        )
    return pd.DataFrame({
        "file_key": results_df["file_key"],
        "rain_actual": results_df.get("rain_actual", None),
        "noise_snr_db": results_df.get("noise__snr_db", np.nan),
        "noise_floor_db": results_df.get("noise__floor_db", np.nan),
    })
