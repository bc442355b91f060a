"""ETL: DSD and dsp-classification backfills from raw audio.

Counterpart of ``audio_processing_tools_tpu/transform.py``: the DSD
emulator's minute vectors become right-edge-minute DataFrames, drop bins get
the inverse-log weighting, and ``dsd_from_audio_keys`` runs a DB-cached
backfill (fetch -> parse -> first 60 s -> emulate -> weight -> upsert
``dsd_from_raw_audio``).  ``dsp_classification_from_audio_keys`` is its
classification twin: per-minute RoE drop counts stamped with
``dsp_classifier_version`` and upserted to
``dsp_classification_from_raw_audio``; all complete minutes of a recording
are one RoE batch on the card (:func:`_classify_minutes`).

pandas is imported only inside the functions that build a DataFrame, so the
card's work (:func:`_classify_minutes`) runs where pandas is missing.  The
S3 and DB layers are the gated modules in ``io``.
"""

from __future__ import annotations

import datetime as dt
from concurrent.futures import ThreadPoolExecutor, as_completed
from typing import TYPE_CHECKING, List, Optional, Sequence, Tuple

import numpy as np
import torch

from audio_processing_tools_tpu_torch import __version__ as _pkg_version
from audio_processing_tools_tpu_torch.host_analysis.dsd_emulator import DsdProcessingEmulator
from audio_processing_tools_tpu_torch.io.audio import pcm_to_float
from audio_processing_tools_tpu_torch.io.mark import parse_mark_audio_file, parse_s3_audio_key

if TYPE_CHECKING:
    import pandas as pd

RAIN_ENERGY_THRESHOLD = 0.6
RAIN_LOG_FACTOR = 0.6
SECONDS_PER_MINUTE = 60


def _utcfromtimestamp(ts) -> dt.datetime:
    """Naive-UTC timestamp (utcfromtimestamp is deprecated)."""
    return dt.datetime.fromtimestamp(float(ts), dt.timezone.utc).replace(tzinfo=None)


def butter_bandpass(lowcut, highcut, fs, order=5):
    """Bandpass (b, a) design (``transform.py:41-45``)."""
    import scipy.signal as spsig

    return spsig.butter(order, [lowcut, highcut], fs=fs, btype="band")


def butter_bandpass_filter(data, lowcut, highcut, fs, order=5):
    """lfilter-based bandpass (``transform.py:48-53``)."""
    import scipy.signal as spsig

    b, a = butter_bandpass(lowcut, highcut, fs, order=order)
    return spsig.lfilter(b, a, data)


def get_package_version() -> str:
    """Version stamp for ETL outputs (``transform.py:56-58``)."""
    return _pkg_version


def fetch_audio_data(key: str, boto_session=None):
    """Single-key fetch with prod->test bucket fallback (``transform.py:61-71``)."""
    from audio_processing_tools_tpu_torch.io.fetch import fetch_raw_audio_from_s3

    try:
        return fetch_raw_audio_from_s3(key, "arable-device-data", boto_session)
    except Exception:
        return fetch_raw_audio_from_s3(key, "arable-device-data-test", boto_session)


def get_real_fft_df(sig, sample_rate) -> "pd.DataFrame":
    """Real-FFT amplitude DataFrame (``transform.py:74-80``)."""
    import pandas as pd

    n = len(sig)
    y = np.fft.fft(sig)
    x = np.fft.fftfreq(n, 1.0 / sample_rate)[: n // 2]
    amplitude = 2.0 / n * np.abs(y[: n // 2])
    return pd.DataFrame({"frequency": x, "amplitude": amplitude})


def emulator_output_to_df(output, device_id, audio_start_timestamp,
                          output_interval_min: int = 1) -> "pd.DataFrame":
    """Minute vectors -> DataFrame with right-edge timestamps
    (``transform.py:83-101``)."""
    import pandas as pd

    dsd_cols = [f"dsd{i}" for i in range(32)]
    pft_cols = [f"pft{i}" for i in range(30)]
    fft_cols = [f"fft{i}" for i in range(38)]
    df = pd.DataFrame(output, columns=dsd_cols + pft_cols + fft_cols)
    if isinstance(audio_start_timestamp, (int, float, np.integer, np.floating)):
        audio_start_timestamp = _utcfromtimestamp(float(audio_start_timestamp))
    timestamps = pd.date_range(
        audio_start_timestamp + dt.timedelta(minutes=1),
        periods=len(df), freq=f"{output_interval_min}min",
    )
    df["time"] = timestamps
    df["device"] = device_id
    return df


def validate_db_engine(db_engine) -> None:
    """ADSE-engine guard (``transform.py:104-111``)."""
    import sqlalchemy

    if not isinstance(db_engine, sqlalchemy.engine.base.Engine):
        raise Exception(f"Did not recognize db engine type: {type(db_engine)}")
    if "adse" not in str(db_engine.url):
        raise Exception("Must provide db_engine that connects to ADSE database")


def reverse_binning_func(drop_bin, threshold: float = RAIN_ENERGY_THRESHOLD):
    """Inverse of the firmware log binning (``transform.py:114-116``)."""
    return (((np.e ** (drop_bin * np.log(1.13))) - 1) / RAIN_LOG_FACTOR) + threshold


dsd_weights = {f"dsd{i}": reverse_binning_func(i) for i in range(32)}


def add_weighted_dsd_data(df: "pd.DataFrame", weights=None, add_to_df: bool = True,
                          add_weighted_dsd_sum: bool = False) -> "pd.DataFrame":
    """Drop-size weighting (``transform.py:122-133``)."""
    import pandas as pd

    if weights is None:
        weights = dsd_weights.values()
    dsd_columns = [f"dsd{i}" for i in range(32)]
    weighted = (df[dsd_columns] * list(weights)).add_suffix("_weighted")
    if add_weighted_dsd_sum:
        weighted["weighted_dsd_sum"] = weighted.sum(axis=1)
    if add_to_df:
        return pd.concat([df, weighted], axis=1)
    return weighted


def process_audio_file_dsd(key: str, local_cache_location: Optional[str],
                           verbose: bool, reprocess: bool) -> "pd.DataFrame":
    """Per-key worker: fetch -> parse -> first 60 s -> emulate -> weight
    (``transform.py:136-169``)."""
    from audio_processing_tools_tpu_torch.io.fetch import get_device_raw_audio_data

    raw = get_device_raw_audio_data(
        local_cache_location=local_cache_location, header_only=False,
        keys=[key], verbose=verbose, max_threads=1, show_progress=False,
    )[key]
    sig, metadata = parse_mark_audio_file(raw)
    metadata = {**metadata, **parse_s3_audio_key(key)}

    sr = metadata["sample_rate"]
    if round(len(sig) / sr) > 60:
        sig_to_process = sig[: 60 * sr]
    else:
        sig_to_process = sig

    emu = DsdProcessingEmulator(fs=sr, frame_length=512, hop_length=512,
                                bwindow=False, ts=0, verbose=verbose)
    dsd_output = emu.process_audio_data(pcm_to_float(sig_to_process), ts=0)
    df = emulator_output_to_df(dsd_output, metadata["device_id"], metadata["time"])
    df["key"] = key
    df["update_time"] = dt.datetime.now(dt.timezone.utc).replace(tzinfo=None)
    df["duration"] = round(len(sig_to_process) / sr)
    df["weighted_dsd_sum"] = add_weighted_dsd_data(
        df, add_to_df=False, add_weighted_dsd_sum=True
    )["weighted_dsd_sum"]
    df["sample_rate"] = sr
    df["dsd_emulator_version"] = _pkg_version
    if reprocess is False:
        df["create_time"] = df["update_time"]
    return df


def _classify_minutes(sigs: Sequence[np.ndarray], sr: int,
                      classifier_params: Optional[dict] = None,
                      device: str | torch.device = "cuda"
                      ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """The classification ETL's device part (``transform.py:194-207``) for
    one or more int16 recordings at ``sr``: every complete minute of each,
    scaled by ``pcm_to_float``, is a row of one ``roe_detect_batch`` on
    ``device``.  Returns ``(rain_drop_count_mod, frain_mean)`` per
    recording, one value a minute, as NumPy.  Needs no pandas."""
    from audio_processing_tools_tpu_torch.models.roe import roe_detect_batch

    counts = [int(round(len(sig) / sr, 1) // SECONDS_PER_MINUTE) for sig in sigs]
    if min(counts) < 1:
        raise ValueError("Cannot process audio file with duration less than 1 minute")
    spm = SECONDS_PER_MINUTE * sr
    minutes = np.stack([pcm_to_float(sig[i * spm : (i + 1) * spm])
                        for sig, m in zip(sigs, counts) for i in range(m)])
    params = dict(classifier_params or {})
    params.setdefault("sample_rate", sr)
    out = roe_detect_batch(minutes, device=device, **params)
    bounds = np.cumsum([0] + counts)
    return [(out["rain_drop_count_mod"][a:b], out["frain_mean"][a:b])
            for a, b in zip(bounds[:-1], bounds[1:])]


def process_audio_file_classification(
    key: str, local_cache_location: Optional[str], verbose: bool,
    reprocess: bool, classifier_params: Optional[dict] = None,
    device: str | torch.device = "cuda",
) -> "pd.DataFrame":
    """Per-key worker: fetch -> parse -> per-minute RoE classification
    (``transform.py:172-227``): the recording's complete minutes are one
    batch on ``device``."""
    import pandas as pd

    from audio_processing_tools_tpu_torch.io.fetch import get_device_raw_audio_data

    raw = get_device_raw_audio_data(
        local_cache_location=local_cache_location, header_only=False,
        keys=[key], verbose=verbose, max_threads=1, show_progress=False,
    )[key]
    sig, metadata = parse_mark_audio_file(raw)
    metadata = {**metadata, **parse_s3_audio_key(key)}
    sr = metadata["sample_rate"]
    [(drops, frain)] = _classify_minutes([sig], sr, classifier_params, device)

    rows = []
    for i in range(len(drops)):
        rows.append({
            "key": key,
            # device DSD rows are right-edge labeled; audio files are
            # left-edge: shift one minute for consistency
            "time": metadata["time"] + dt.timedelta(minutes=1 + i),
            "rain_drop_count": int(drops[i]),
            "frain_mean": float(frain[i]),
            "sample_rate": sr,
        })
    df = pd.DataFrame(rows)
    df["dsp_classifier_version"] = _pkg_version
    df["device"] = metadata["device_id"]
    df["update_time"] = dt.datetime.now(dt.timezone.utc).replace(tzinfo=None)
    if reprocess is False:
        df["create_time"] = df["update_time"]
    return df


def dsp_classification_from_audio_keys(
    s3_file_keys: List[str], db_engine, reprocess: bool = False,
    verbose: bool = False, local_cache_location: str = "raw_audio_cache",
    max_workers: Optional[int] = None,
    classifier_params: Optional[dict] = None,
    device: str | torch.device = "cuda",
) -> "pd.DataFrame":
    """DB-cached dsp-classification backfill over S3 keys
    (``transform.py:230-282``): check the
    ``dsp_classification_from_raw_audio`` cache, classify missing keys
    minute by minute on ``device``, stamp ``dsp_classifier_version``,
    upsert."""
    import pandas as pd

    from audio_processing_tools_tpu_torch.io.db import get_db_data, upsert_df

    validate_db_engine(db_engine)

    query = (
        "SELECT * FROM dsp_classification_from_raw_audio "
        f"WHERE key IN {tuple(s3_file_keys)}"
    )
    existing = get_db_data(query, db_engine)
    existing_keys = set(existing["key"].tolist()) if not existing.empty else set()

    keys_to_process = (
        list(s3_file_keys) if reprocess
        else [k for k in s3_file_keys if k not in existing_keys]
    )

    results = []
    with ThreadPoolExecutor(max_workers=max_workers) as ex:
        futures = {
            ex.submit(process_audio_file_classification, k,
                      local_cache_location, verbose, reprocess,
                      classifier_params, device): k
            for k in keys_to_process
        }
        for fut in as_completed(futures):
            results.append(fut.result())
            if verbose:
                print(f"Classified key: {futures[fut]}")

    processed = pd.concat(results, ignore_index=True) if results else pd.DataFrame()

    if not processed.empty:
        upsert_df(processed.set_index(["key", "time"]),
                  "dsp_classification_from_raw_audio", db_engine)

    if not reprocess:
        if not processed.empty:
            return pd.concat([existing, processed], ignore_index=True)
        return existing
    return processed


def dsd_from_audio_keys(s3_file_keys: List[str], db_engine, reprocess: bool = False,
                        verbose: bool = False,
                        local_cache_location: str = "raw_audio_cache",
                        max_workers: Optional[int] = None) -> "pd.DataFrame":
    """DB-cached DSD backfill over S3 keys (``transform.py:285-325``)."""
    import pandas as pd

    from audio_processing_tools_tpu_torch.io.db import get_db_data, upsert_df

    validate_db_engine(db_engine)

    query = f"SELECT * FROM dsd_from_raw_audio WHERE key IN {tuple(s3_file_keys)}"
    existing = get_db_data(query, db_engine)
    existing_keys = set(existing["key"].tolist()) if not existing.empty else set()

    keys_to_process = (
        list(s3_file_keys) if reprocess
        else [k for k in s3_file_keys if k not in existing_keys]
    )

    results = []
    with ThreadPoolExecutor(max_workers=max_workers) as ex:
        futures = {
            ex.submit(process_audio_file_dsd, k, local_cache_location, verbose,
                      reprocess): k
            for k in keys_to_process
        }
        for fut in as_completed(futures):
            results.append(fut.result())
            if verbose:
                print(f"Processed and fetched results for key: {futures[fut]}")

    processed = pd.concat(results, ignore_index=True) if results else pd.DataFrame()

    if not processed.empty:
        upsert_df(processed.set_index(["key", "time"]), "dsd_from_raw_audio",
                  db_engine)

    if not reprocess:
        if not processed.empty:
            return pd.concat([existing, processed], ignore_index=True)
        return existing
    return processed
