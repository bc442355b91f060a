"""Audio normalization, key discovery, and batch loading (host side).

Copy of ``audio_processing_tools_tpu/io/audio.py``: the card's machine has
no JAX, so the port keeps its own copy (standard library ``wave``, NumPy,
scipy; pandas, SQLAlchemy and boto3 only inside the functions that need
them).  API parity with the reference ``audio_io.py``: ``safe_to_float``,
``ensure_mono_len_sr``, the four ``InputType`` key-discovery modes, and the
``get_input_data`` batch loader whose output feeds the device pipeline.

Deviations from the reference, by design:
  * WAV reading uses the stdlib ``wave`` module + NumPy (librosa is not a
    dependency); resampling uses a polyphase resampler
    (``scipy.signal.resample_poly``) instead of librosa/soxr.
  * DB-backed modes are import-gated on SQLAlchemy.
"""

from __future__ import annotations

import os
import wave
from math import gcd
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from audio_processing_tools_tpu_torch.io.mark import parse_mark_audio_file

bytes_per_sample = 2


def pcm_to_float(signal, scale_factor: int = 1 << (bytes_per_sample * 8 - 1)):
    """int16 PCM -> float, scale 1<<15 (parity with ``parse.py:670``)."""
    return signal / scale_factor


def safe_to_float(data, bytes_per_sample: int = 2, signed: bool = True) -> np.ndarray:
    """Raw PCM / numeric array -> float32 in [-1, 1]
    (parity with ``audio_io.py:34-72``: int16 scale 32767, floats clipped)."""
    if isinstance(data, (bytes, bytearray, memoryview)):
        if bytes_per_sample != 2 or not signed:
            raise ValueError("Only 16-bit signed PCM input is supported.")
        arr = np.frombuffer(data, dtype="<i2")
    else:
        arr = np.asarray(data)

    if np.issubdtype(arr.dtype, np.floating):
        out = arr.astype(np.float32, copy=False)
        return np.clip(out, -1.0, 1.0)
    if arr.dtype != np.int16:
        raise ValueError(f"Unsupported dtype {arr.dtype}; expected int16 or float.")
    return arr.astype(np.float32) / np.float32(32767.0)


def resample_poly(y: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Polyphase resampler (scipy).  Replaces librosa.resample host-side."""
    import scipy.signal as spsig

    g = gcd(int(sr_in), int(sr_out))
    up, down = int(sr_out) // g, int(sr_in) // g
    return spsig.resample_poly(y.astype(np.float64), up, down).astype(np.float32)


def ensure_mono_len_sr(y: np.ndarray, sr_in: int, sr_out: int,
                       duration_s: float) -> Optional[np.ndarray]:
    """Mono + resample + trim to fixed duration (``audio_io.py:75-120``)."""
    y = np.asarray(y)
    if y.ndim == 2:
        y = y.mean(axis=0) if y.shape[0] < y.shape[1] else y.mean(axis=1)
    if sr_in != sr_out:
        y = resample_poly(y.astype(np.float32, copy=False), sr_in, sr_out)
    required = int(sr_out * duration_s)
    if y.size < required:
        return None
    y = y[:required].astype(np.float32, copy=False)
    return np.clip(y, -1.0, 1.0)


def load_wav(path: str) -> tuple[np.ndarray, int]:
    """Read a WAV file into float32 [-1, 1] (8-, 16- or 32-bit integer PCM,
    mono or more channels).  Returns ``(samples, sample_rate)`` with samples
    ``(n,)`` for mono, ``(channels, n)`` otherwise."""
    with wave.open(path, "rb") as wf:
        sr = wf.getframerate()
        n_ch = wf.getnchannels()
        width = wf.getsampwidth()
        raw = wf.readframes(wf.getnframes())
    if width == 2:
        arr = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        arr = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        arr = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported WAV sample width {width}")
    if n_ch > 1:
        arr = arr.reshape(-1, n_ch).T  # (channels, n)
    return arr, sr


def write_wav(path: str, y: np.ndarray, sr: int) -> None:
    """Write float [-1,1] or int16 audio to a 16-bit mono/stereo WAV."""
    y = np.asarray(y)
    if np.issubdtype(y.dtype, np.floating):
        y = (np.clip(y, -1.0, 1.0) * 32767.0).astype(np.int16)
    n_ch = 1 if y.ndim == 1 else y.shape[0]
    if y.ndim == 2:
        y = y.T.reshape(-1)
    with wave.open(path, "wb") as wf:
        wf.setnchannels(n_ch)
        wf.setsampwidth(2)
        wf.setframerate(int(sr))
        wf.writeframes(y.astype("<i2").tobytes())


# ----------------------------------------------------------------------
# Key discovery (InputType parity with audio_io.get_keys)
# ----------------------------------------------------------------------


def get_local_file_list(test_vector_path, file_path: str = "local_keys.csv",
                        localStatus: bool = True) -> List[Dict[str, Any]]:
    """Recursive scan for .bin/.wav; rain label from 'true'/'false' in path
    (``audio_io.py:173-230``)."""
    if os.path.exists(file_path):
        import pandas as pd

        df = pd.read_csv(file_path)
        if {"source_file", "raining"}.issubset(df.columns):
            return df[["source_file", "raining"]].to_dict(orient="records")
        print(f"Warning: {file_path} missing required columns; ignoring cache.")

    if not test_vector_path:
        raise ValueError("test_vector_path must be provided for LocalPath input.")

    keys: List[Dict[str, Any]] = []
    for fname in sorted(Path(test_vector_path).rglob("*")):
        if not fname.is_file():
            continue
        if fname.suffix.lower() in (".bin", ".wav"):
            fstr = str(fname).lower()
            raining = True if "true" in fstr else (False if "false" in fstr else localStatus)
            keys.append({"source_file": str(fname), "raining": raining})
    return keys


def get_db_file_list(query: str, adse_engine, file_path: str = "db_keys.csv"
                     ) -> List[Dict[str, Any]]:
    """SQL -> [{'source_file','raining'}], with CSV-cache shortcut."""
    import pandas as pd

    if os.path.exists(file_path):
        df = pd.read_csv(file_path)
        if {"source_file", "raining"}.issubset(df.columns):
            return df[["source_file", "raining"]].to_dict(orient="records")
        print(f"Warning: {file_path} missing required columns; ignoring cache.")

    from audio_processing_tools_tpu_torch.io.db import get_db_data

    df = get_db_data(query, adse_engine)
    if not {"source_file", "raining"}.issubset(df.columns):
        raise ValueError("DB result must contain columns: 'source_file', 'raining'")
    return df[["source_file", "raining"]].to_dict(orient="records")


def batched_query_to_dict_records(source_files: List[str], adse_engine,
                                  batch_size: int = 1000) -> List[Dict[str, Any]]:
    """Hydrate labels from ``public.device_audio_rain_classification``
    (``audio_io.py:233-274``)."""
    records: List[Dict[str, Any]] = []
    for i in range(0, len(source_files), batch_size):
        batch = source_files[i : i + batch_size]
        placeholders = ", ".join(f"'{s}'" for s in batch)
        q = (
            "SELECT source_file, raining "
            "FROM public.device_audio_rain_classification "
            f"WHERE source_file IN ({placeholders});"
        )
        records.extend(get_db_file_list(q, adse_engine))
    return records


def get_keys(InputType: str, test_vector_path: Optional[str] = None,
             query: Optional[str] = None, adse_engine=None,
             batch_size: int = 1000, localStatus: bool = True,
             csv_inp_file: Optional[str] = None,
             key_list: Optional[List[str]] = None) -> List[Dict[str, Any]]:
    """Key records with 'source_file'/'raining' (``audio_io.py:277-343``)."""
    if InputType == "LocalPath":
        if not test_vector_path:
            raise ValueError("LocalPath requires 'test_vector_path'.")
        return get_local_file_list(test_vector_path, localStatus=localStatus)
    if InputType == "RemotePath":
        if not query:
            raise ValueError("RemotePath requires 'query'.")
        if adse_engine is None:
            raise ValueError("RemotePath requires a valid 'adse_engine'.")
        return get_db_file_list(query, adse_engine)
    if InputType == "CsvInput":
        if not csv_inp_file:
            raise ValueError("CsvInput requires 'csv_inp_file'.")
        if adse_engine is None:
            raise ValueError("CsvInput requires a valid 'adse_engine'.")
        import pandas as pd

        df = pd.read_csv(csv_inp_file)
        if "source_file" not in df.columns:
            raise ValueError("CsvInput CSV must contain a 'source_file' column.")
        source_files = df["source_file"].dropna().astype(str).tolist()
        return batched_query_to_dict_records(source_files, adse_engine, batch_size)
    if InputType == "KeyList":
        if not key_list:
            raise ValueError("KeyList requires 'key_list'.")
        if adse_engine is None:
            raise ValueError("KeyList requires a valid 'adse_engine'.")
        return batched_query_to_dict_records(key_list, adse_engine, batch_size)
    raise ValueError(
        f"Unknown InputType '{InputType}'. Expected one of: "
        "'LocalPath', 'RemotePath', 'CsvInput', 'KeyList'."
    )


# ----------------------------------------------------------------------
# Batch loading
# ----------------------------------------------------------------------


def get_input_data(batch_keys: List[Dict[str, Any]], InputType: str, Fs: int,
                   check_duration: float, localStatus: bool,
                   local_cache: Optional[str], read_size: Optional[int],
                   bytes_per_sample: int = 2,
                   **augment_kwargs) -> Dict[str, Dict[str, Any]]:
    """Load a batch of keys into normalized float32 buffers
    (``audio_io.py:350-477``); remote keys via the S3 fetch layer.

    ``augment_kwargs`` supports test-only input augmentation:
    ``noise_injector(key, y) -> (y, info)`` adds ``synthetic_noise_info``.
    """
    dir_content: Dict[str, Dict[str, Any]] = {}
    required_samples = int(Fs * check_duration)
    noise_injector = augment_kwargs.get("noise_injector")

    def _store(key: str, y: np.ndarray, raining) -> None:
        entry: Dict[str, Any] = {"file_contents": y, "raining": raining}
        if noise_injector is not None:
            y2, info = noise_injector(key, y)
            entry["file_contents"] = np.asarray(y2, np.float32)
            entry["synthetic_noise_info"] = info
        dir_content[key] = entry

    if InputType == "LocalPath":
        for key in batch_keys:
            audio_path = key["source_file"]
            raining = key.get("raining", localStatus)
            if audio_path.lower().endswith(".wav"):
                try:
                    y, sr = load_wav(audio_path)
                except Exception as e:
                    print(f"Error loading WAV file {audio_path}: {e}")
                    continue
                y = ensure_mono_len_sr(y, sr_in=sr, sr_out=Fs, duration_s=check_duration)
                if y is None:
                    continue
                _store(audio_path, y, raining)
                continue
            try:
                with open(audio_path, "rb") as f:
                    raw = f.read()
                audio_i16, _meta = parse_mark_audio_file(raw)
                y = safe_to_float(audio_i16, bytes_per_sample=bytes_per_sample)
                y = ensure_mono_len_sr(y, sr_in=Fs, sr_out=Fs, duration_s=check_duration)
                if y is None:
                    continue
                _store(audio_path, y, raining)
            except Exception as e:
                print(f"Error reading local file {audio_path}: {e}")
                continue
        return dir_content

    # remote / S3
    from audio_processing_tools_tpu_torch.io.fetch import get_device_raw_audio_data

    source_files = [k["source_file"] for k in batch_keys]
    raw_map = get_device_raw_audio_data(
        keys=source_files, local_cache_location=local_cache, header_only=False
    )
    for key in batch_keys:
        s = key["source_file"]
        raining = key.get("raining", False)
        raw = raw_map.get(s)
        if raw is None:
            continue
        if len(raw) % 2:
            raw = raw[:-1]
        if len(raw) < 2 * required_samples:
            continue
        try:
            audio_i16, _meta = parse_mark_audio_file(raw)
            y = safe_to_float(audio_i16, bytes_per_sample=bytes_per_sample)
            y = ensure_mono_len_sr(y, sr_in=Fs, sr_out=Fs, duration_s=check_duration)
            if y is None:
                continue
            _store(s, y, raining)
        except Exception as e:
            print(f"Error parsing remote audio for {s}: {e}")
            continue
    return dir_content
