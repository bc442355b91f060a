"""Interactive ground-truth labeling UI (parity with reference ``labeler.py``).

Counterpart of ``audio_processing_tools_tpu/labeler.py`` (``:32-390``), over
the port's ``io/mark.py``, ``io/audio.py``, ``io/db.py``, ``io/fetch.py``
and ``viz/visualize_audio.py``.  The labeler is the fixture factory of the
system: human labels land in ``device_audio_rain_classification`` keyed by a
sha256 uid of (source_file, segment bounds), upserted on fire-and-forget
daemon threads.

pandas, the Jupyter-only pieces (ipywidgets, IPython audio), matplotlib and
requests import inside the functions that need them, so the module loads
headless and without them.
"""

from __future__ import annotations

import datetime as dt
import hashlib
import threading
import time
from collections import deque
from pathlib import Path
from typing import Callable, Optional

import numpy as np

from audio_processing_tools_tpu_torch.io.audio import pcm_to_float, write_wav
from audio_processing_tools_tpu_torch.io.mark import parse_mark_audio_file

# the five widget panes a labeling session renders into, in display order
_PANES = ("main_output", "audio_output", "signal_output",
          "spectrogram_output", "figure_output")


def _source_indexed(df):
    """Validate the clip table (a pandas DataFrame) and key it by
    ``source_file``.

    Every clip needs a distinct, non-null source key — labels are addressed
    by it (the uid hashes it), so a bad table fails fast here rather than
    mid-session.
    """
    import pandas as pd

    out = df.copy()
    key = "source_file"
    if key not in out.columns:
        raise ValueError(f"clip table is missing the {key!r} column")
    col = out[key]
    if col.isnull().any():
        raise ValueError(f"clip table has empty {key!r} entries")
    if col.duplicated().any():
        dupes = col[col.duplicated()].tolist()[:3]
        raise ValueError(f"clip table repeats {key!r} values (e.g. {dupes})")
    if not out.index.equals(pd.Index(col)):
        out = out.set_index(key, drop=False)
    return out


class TestVectorLabeler:
    __test__ = False  # reference-parity name starts with "Test"; not a test

    def __init__(
        self,
        audio_df,
        db_engine,
        db_engine_upsert=None,
        max_duration_seconds: int = 15,
        local_audio_cache: str = "./raw_audio_cache",
        out_folder: Optional[str] = None,
        normalize_audio: bool = True,
        autoplay: bool = True,
        visualize_device_context: bool = False,
        context_window_days: int = 5,
        add_ibm_data: bool = True,
        visualize_time_series_signal: bool = False,
        visualize_signal_spectrogram: bool = False,
    ):
        self.audio_df = _source_indexed(audio_df)
        self.db_engine = db_engine
        self.db_engine_upsert = db_engine_upsert or db_engine
        # everything else is a plain session option; carry them verbatim
        opts = dict(
            max_duration_seconds=max_duration_seconds,
            local_audio_cache=local_audio_cache,
            normalize_audio=normalize_audio,
            autoplay=autoplay,
            visualize_device_context=visualize_device_context,
            context_window_days=context_window_days,
            add_ibm_data=add_ibm_data,
            visualize_time_series_signal=visualize_time_series_signal,
            visualize_signal_spectrogram=visualize_signal_spectrogram,
        )
        for name, value in opts.items():
            setattr(self, name, value)
        self.out_folder = None
        if out_folder is not None:
            self.out_folder = Path(out_folder).expanduser().resolve()
            self.out_folder.mkdir(parents=True, exist_ok=True)
        self.reset()

    # ------------------------------------------------------------------
    def reset(self) -> None:
        """Rewind navigation and give the session fresh widget panes."""
        from ipywidgets import Output

        self.index_list = self.audio_df.index
        self.index_iter = iter(self.index_list)
        self.history_stack: deque = deque()
        self.upsert_threads: list = []
        for pane in _PANES:
            setattr(self, pane, Output())

    def label_vectors(self) -> None:
        """Start a fresh labeling session from the first file."""
        from IPython.display import display

        self.reset()
        for pane in _PANES:
            display(getattr(self, pane))
        self.process_next_index()

    def process_next_index(self) -> None:
        from IPython.display import clear_output

        here = next(self.index_iter, None)
        if here is None:  # ran off the end of the clip table
            with self.main_output:
                clear_output(wait=True)
                print("All files have been processed.")
            return
        self.history_stack.append(here)
        self.process_index(here, self.process_next_index, self.main_output)

    def process_previous_index(self) -> None:
        if len(self.history_stack) < 2:
            with self.main_output:
                print("No previous file to go back to.")
            return
        self.history_stack.pop()          # leave the current clip
        back = self.history_stack.pop()   # land on the one before it
        # resume forward iteration from the revisited position
        self.index_iter = iter(self.index_list[self.index_list.get_loc(back):])
        self.process_index(back, self.process_next_index, self.main_output)

    # ------------------------------------------------------------------
    @staticmethod
    def str_to_bool(s: str) -> bool:
        return str(s).lower() == "true"

    @staticmethod
    def generate_uid(data: str) -> str:
        h = hashlib.sha256()
        h.update(data.encode())
        return h.hexdigest()

    @staticmethod
    def fetch_ibm_data(db_engine, start_date, end_date, lat, long):
        """IBM weather overlay query (``labeler.py:133-146``)."""
        from audio_processing_tools_tpu_torch.io.db import get_db_data

        q = f"""
        SELECT time_utc as time, precip as ibm_precip
        FROM ext_weather.hist_local_hourly
        WHERE time_utc BETWEEN '{start_date:%Y-%m-%d %H:%M:%S}'
              AND '{end_date:%Y-%m-%d %H:%M:%S}'
          AND lat BETWEEN {lat} - 0.005 AND {lat} + 0.005
          AND long BETWEEN {long} - 0.005 AND {long} + 0.005
        """
        return get_db_data(q, db_engine)

    @staticmethod
    def plot_device_context(db_engine, key_of_interest, audio_df, window_size,
                            display_ibm_data):
        """Adjacent recordings (+ optional IBM precip) around the clip."""
        import matplotlib.pyplot as plt
        import pandas as pd

        clip = audio_df.loc[key_of_interest]
        pivot, dev = clip["time"], clip["device_id"]
        half = pd.Timedelta(days=window_size / 2)
        t0, t1 = pivot - half, pivot + half
        nearby = audio_df["device_id"].eq(dev) & audio_df["time"].between(t0, t1)
        peers = audio_df.loc[nearby, "time"]

        _fig, ax = plt.subplots(figsize=(10, 3))
        ax.plot(peers, [dev] * len(peers), "o",
                label="Adjacent Audio Recordings", markersize=4)
        ax.plot([pivot], [dev], "ro", label="Current Audio File")
        ax.set_title(f"Audio Context For {dev}")
        ax.legend(fontsize=8)

        def _ibm_overlay():
            lat, long = clip["lat"], clip["long"]
            bad = pd.isnull(lat) or pd.isnull(long) or (lat == 0 and long == 0)
            if bad:
                print("Could not get IBM data due to bad coordinates")
                return
            try:
                ibm = TestVectorLabeler.fetch_ibm_data(db_engine, t0, t1,
                                                       lat, long)
            except Exception as e:
                print(f"Could not fetch IBM data: {e}")
                return
            if ibm.empty:
                print(f"IBM data for {lat}, {long} not found in db")
                return
            twin = ax.twinx()
            twin.plot(ibm["time"], ibm["ibm_precip"], "-", color="tab:blue",
                      label="IBM precip")
            twin.set_ylabel("IBM rain (mm)")

        if display_ibm_data:
            _ibm_overlay()
        plt.show()

    # ------------------------------------------------------------------
    def process_index(self, index: str, next_index_callback: Callable,
                      output_widget) -> None:
        from IPython.display import Audio, clear_output, display
        from ipywidgets import Button, HBox

        from audio_processing_tools_tpu_torch.io.fetch import get_device_raw_audio_data
        from audio_processing_tools_tpu_torch.viz.visualize_audio import (
            plot_audio_signal,
            plot_audio_spectrogram,
        )

        with output_widget:
            clip_row = self.audio_df.loc[index].copy()
            clear_output(wait=True)
            src = clip_row["source_file"]
            pos = self.index_list.get_loc(index) + 1
            print(f"File {pos} of {len(self.index_list)}")

            fetched = get_device_raw_audio_data(
                keys=[src], local_cache_location=self.local_audio_cache,
                redownload=False, use_caching=True, header_only=False,
                verbose=False,
            )
            try:
                blob = fetched[src]
            except KeyError:
                raise KeyError(
                    f"Fetched audio data does not contain key {src!r}."
                ) from None
            sig, meta = parse_mark_audio_file(blob)
            fs = meta["sample_rate"]
            t0, t1 = 0, min(len(sig) / fs, self.max_duration_seconds)
            clip_row["segment_start_seconds"] = t0
            clip_row["segment_end_seconds"] = t1
            print(f"Working on {src} from {t0}s to {t1}s")

            seg = pcm_to_float(sig[int(t0 * fs) : int(t1 * fs)])

            with self.audio_output:
                clear_output(wait=True)
                display(Audio(data=seg, rate=fs,
                              normalize=self.normalize_audio,
                              autoplay=self.autoplay))

            row = []
            for desc, handler in (
                ("Raining", self.make_button_handler(
                    clip_row, output_widget, True, next_index_callback)),
                ("Not Raining", self.make_button_handler(
                    clip_row, output_widget, False, next_index_callback)),
                ("Skip", lambda b: next_index_callback()),
                ("Save for Review", self.make_save_for_review_handler(
                    clip_row, blob, output_widget)),
                ("Go Back", lambda b: self.process_previous_index()),
            ):
                btn = Button(description=desc)
                btn.on_click(handler)
                row.append(btn)
            display(HBox(row))

            # optional side panels, each into its own persistent pane
            panels = (
                (self.visualize_time_series_signal, self.signal_output,
                 lambda: plot_audio_signal(seg, fs, title=src)),
                (self.visualize_signal_spectrogram, self.spectrogram_output,
                 lambda: plot_audio_spectrogram(seg, fs)),
                (self.visualize_device_context, self.figure_output,
                 lambda: self.plot_device_context(
                     self.db_engine, index, self.audio_df,
                     self.context_window_days, self.add_ibm_data)),
            )
            for enabled, pane, render in panels:
                if not enabled:
                    continue
                with pane:
                    clear_output(wait=True)
                    render()

    # ------------------------------------------------------------------
    def make_save_for_review_handler(self, audio_file_data, audio_binary,
                                     output_widget) -> Callable:
        def on_click(b):
            with output_widget:
                try:
                    self.save_file_for_review(audio_file_data, audio_binary,
                                              output_widget)
                except Exception as e:
                    print(f"Error while saving file for review: {e}")

        return on_click

    def make_button_handler(self, data, output_widget, rain_status: bool,
                            next_index_callback: Callable) -> Callable:
        def on_click(b):
            try:
                self.update_rain_label(data, rain_status, output_widget)
                time.sleep(0.5)
                next_index_callback()
            except Exception as e:
                print(f"Error in button handler: {e}")

        return on_click

    def update_rain_label(self, audio_file_data, rain_status: bool,
                          output_widget) -> None:
        """Build the label row and upsert it on a daemon thread
        (``labeler.py:358-414``)."""
        import pandas as pd
        from IPython.display import display

        with output_widget:
            display(f"Rain label being updated to "
                    f"{'TRUE' if rain_status else 'FALSE'}...")
            now = dt.datetime.now(dt.timezone.utc).replace(tzinfo=None)
            src = audio_file_data["source_file"]
            seg_a = audio_file_data["segment_start_seconds"]
            seg_b = audio_file_data["segment_end_seconds"]
            row = {
                "uid": self.generate_uid(f"{src}{seg_a}{seg_b}"),
                "source_file": src,
                "device": audio_file_data["device_id"],
                "start_time": audio_file_data["time"],
                "segment_start_seconds": seg_a,
                "segment_end_seconds": seg_b,
                "site": None,
                "source": "manually labeled",
                "raining": rain_status,
                "corrected": False,
                "creator": self._creator_tag(),
                "update_time": now,
                "create_time": now,
                "manually_labeled": True,
            }
            data = pd.DataFrame([row]).set_index("uid")
            thread = threading.Thread(
                target=self.background_upsert, args=(data,), daemon=True
            )
            thread.start()
            self.upsert_threads.append(thread)

    @staticmethod
    def _creator_tag() -> str:
        """Public IP of the labeling human, or ``"unknown"`` offline."""
        try:
            import requests

            return requests.get(
                "https://api.ipify.org", timeout=5
            ).content.decode("utf8")
        except Exception:
            return "unknown"

    def background_upsert(self, data) -> None:
        from audio_processing_tools_tpu_torch.io.db import upsert_df

        try:
            upsert_df(data, "device_audio_rain_classification",
                      self.db_engine_upsert)
            print("Database upsert completed successfully.")
        except Exception as e:
            print(f"Error during database upsert: {e}")

    def save_file_for_review(self, audio_file_data, audio_binary: bytes,
                             output_widget) -> None:
        """Export the decoded WAV for offline review (``labeler.py:416-445``)."""
        with output_widget:
            if self.out_folder is None:
                print("out_folder is not configured; cannot save file for review.")
                return
            source_file = str(audio_file_data["source_file"])
            device_id = str(audio_file_data.get("device_id", "unknown_device"))
            out_path = self.out_folder / f"{device_id}_{Path(source_file).stem}.wav"
            print(f"Saving decoded WAV for review to: {out_path}")
            sig, metadata = parse_mark_audio_file(audio_binary)
            write_wav(str(out_path), np.asarray(sig), int(metadata["sample_rate"]))
            if not out_path.exists():
                raise RuntimeError(f"WAV file was not created: {out_path}")
            print(
                f"Saved decoded WAV for review: {out_path} "
                f"({out_path.stat().st_size} bytes)"
            )
