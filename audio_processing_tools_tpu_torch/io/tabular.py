"""Tabular audio helpers: DataFrame wrapping + metadata backfill.

Counterpart of ``audio_processing_tools_tpu/io/tabular.py``, over the
port's ``io/mark.py``, ``io/fetch.py`` and ``io/db.py``; pandas is
imported inside the functions that build a DataFrame.  Parity with the
reference ``parse.py`` L1 helpers: ``AudioSignal`` cell wrapper,
``tabularize_audio_data`` and the batched ``AudioMetadataHandler`` header
-> Postgres backfill (``parse.py:624-757``).
"""

from __future__ import annotations

import datetime as dt
from typing import Dict, Optional

import numpy as np

from audio_processing_tools_tpu_torch.io.mark import (
    parse_mark_audio_file,
    parse_s3_audio_key,
)


def _utcfromtimestamp(ts) -> "dt.datetime":
    """Naive-UTC timestamp (utcfromtimestamp is deprecated)."""
    return dt.datetime.fromtimestamp(float(ts), dt.timezone.utc).replace(
        tzinfo=None
    )


class AudioSignal:
    """Wraps an ndarray so pandas stores it in one cell (``parse.py:624-631``)."""

    def __init__(self, contents):
        self.contents = contents

    def __repr__(self):
        arr = np.asarray(self.contents)
        return f"AudioSignal(n={arr.size}, dtype={arr.dtype})"


def tabularize_audio_data(binary_raw_audio: Dict[str, bytes],
                          device_metadata: bool = True,
                          force_file_type: Optional[str] = None):
    """{key: bytes} -> DataFrame of signals + metadata (``parse.py:634-664``)."""
    import pandas as pd

    rows = []
    for key, datum in binary_raw_audio.items():
        sig, metadata = parse_mark_audio_file(datum, force_file_type=force_file_type)
        if device_metadata:
            metadata = {**metadata, **parse_s3_audio_key(key)}
        rows.append({"signal": AudioSignal(sig), "source_file": key, **metadata,
                     "_key": key})
    df = pd.DataFrame(rows)
    if not df.empty:
        df = df.set_index("_key")
        df.index.name = None
    return df


class AudioMetadataHandler:
    """Fetch headers for many keys and upsert metadata rows in batches
    (``parse.py:674-757``)."""

    def __init__(self, keys: list, sqlalchemy_db_engine,
                 local_audio_cache: str = "./raw_audio_cache",
                 table_name: str = "audio_metadata", batch_size: int = 100):
        self.keys = keys
        self.sqlalchemy_db_engine = sqlalchemy_db_engine
        self.local_audio_cache = local_audio_cache
        self.table_name = table_name
        self.batch_size = batch_size
        self.buffer: list = []

    def fetch_and_store_metadata(self) -> None:
        import pandas as pd

        from audio_processing_tools_tpu_torch.io.fetch import get_device_raw_audio_data

        audio_data = get_device_raw_audio_data(
            keys=self.keys, local_cache_location=self.local_audio_cache,
            redownload=False, use_caching=True, header_only=False,
            verbose=False,
        )
        for key in self.keys:
            if key not in audio_data:
                print(f"Audio data for key {key} could not be fetched.")
                continue
            try:
                _, metadata = parse_mark_audio_file(audio_data[key])
                metadata["time"] = _utcfromtimestamp(metadata["time"])
                metadata["source_key"] = key
                column_order = ["source_key", "device_id", "time", "sample_rate",
                                "lat", "long", "duration"]
                remaining = [c for c in metadata if c not in column_order]
                metadata = {c: metadata[c] for c in column_order + remaining}
                self.buffer.append(
                    pd.DataFrame([metadata]).set_index("source_key")
                )
                if len(self.buffer) >= self.batch_size:
                    self.upsert_batch()
            except Exception as e:
                print(f"Error processing key {key}: {e}")
        if self.buffer:
            self.upsert_batch()

    def upsert_batch(self) -> None:
        import pandas as pd

        from audio_processing_tools_tpu_torch.io.db import upsert_df

        batch = pd.concat(self.buffer)
        self.buffer = []
        try:
            upsert_df(batch, self.table_name, self.sqlalchemy_db_engine)
            print(f"Successfully inserted {len(batch)} entries.")
        except Exception as e:
            print(f"Error during database upsert: {e}")
