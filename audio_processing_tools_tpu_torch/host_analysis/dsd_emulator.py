"""Firmware DSD minute-histogram pipeline emulator (a NumPy host copy).

Copy of ``audio_processing_tools_tpu/host_analysis/dsd_emulator.py``: the
card's machine has no JAX, so the port keeps its own copy of this module,
which is the oracle of ``dsd_device.py``.

Bit-faithful host re-expression of the Mark-3 on-device processing
(reference ``host_analysis/device_dsd_processing_emulator.py``): per minute
of audio the device emits a 100-bin vector —

  * 32 loudness bins : log-binned count histogram of rain-band (400-700 Hz)
    spectral energy above threshold 0.6 (log base 1.13, factor 0.6),
  * 30 pft bins      : per-2-second slots holding the argmax index of a peak
    histogram over 100-1500 Hz,
  * 38 fft bins      : log-scaled accumulated peak energies in two windows
    starting at 300 and 1000 Hz.

Duty cycling: when the previous minute saw no rain, the device skips to the
last 3 s of the next minute (``rain_chk_period_seconds=60``,
``rain_chk_duration_seconds=3``).

Layout parity is exact (the 32+30+38 vector is a wire format used by the
``dsd_from_raw_audio`` backfill).  The emulator is NumPy (it is an analysis
oracle, not a throughput path); :func:`dsd_process_batch` exposes a
vectorized fast path for the always-raining (no duty-cycle) case used in
fleet backfills.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np

HEADER_SIZE = 40
DEFAULT_BYTES_PER_SAMPLE = 2


class DsdProcessingEmulator:
    """Stateful per-minute emulator (API parity with the reference class,
    including ``process_audio_data(audio, ts) -> [minute_vectors]``)."""

    def __init__(self, fs: int = 11162, frame_length: int = 512,
                 hop_length: int = 512, bwindow: bool = False, ts: int = 0,
                 verbose: bool = False):
        self.fs = fs
        self.frame_length = frame_length
        self.fft_n_bins = frame_length // 2
        self.hop_length = hop_length
        self.apply_window = bwindow
        self.verbose = verbose

        self.dF = self.fs / self.frame_length

        self.loudness_bins = 32
        self.pft_bins = 30
        self.fft_bins = 38

        self.rain_chk_period_seconds = 60
        self.rain_chk_duration_seconds = 3

        self.rain_energy_threshold = 0.6
        self.rain_low_freq = 400
        self.rain_high_freq = 700
        self.rain_low_idx = int(self.rain_low_freq // self.dF) + 1
        self.rain_high_idx = int(self.rain_high_freq // self.dF)

        self.rain_log_base = 1.13
        self.rain_log_factor = 0.6

        self.pft_low_freq = 100
        self.pft_high_freq = 1500
        self.pft_low_idx = int(self.pft_low_freq // self.dF) + 1
        self.pft_high_idx = int(self.pft_high_freq // self.dF) - 1

        self.lwin_start = 300
        self.hwin_start = 1000
        self.lwin_start_idx = int(self.lwin_start // self.dF)
        self.lwin_end_idx = self.lwin_start_idx + self.fft_bins // 2 - 1
        self.hwin_start_idx = int(self.hwin_start // self.dF)
        self.hwin_end_idx = self.hwin_start_idx + self.fft_bins // 2 - 1

        self.hdr_size = HEADER_SIZE

        self.ts_start = 0
        self.ts_current = 0
        self.total_frames = 0
        self.frame_count = 0
        self.energy_histogram = np.zeros(
            self.loudness_bins + self.pft_bins + self.fft_bins
        )
        self.peak_histogram = np.zeros(self.fft_n_bins)
        self.freq_histogram = np.zeros(self.fft_n_bins)
        self.raining = True

    # ------------------------------------------------------------------
    def clear_histogram(self) -> None:
        self.energy_histogram.fill(0)
        self.peak_histogram.fill(0)
        self.freq_histogram.fill(0)

    def set_audio_timestamp(self, ts: float, sample_count: int) -> None:
        self.ts_start = ts - (ts % self.rain_chk_period_seconds)
        self.ts_current = ts
        self.frame_count = int(
            (self.ts_current % self.rain_chk_period_seconds)
            * self.fs / self.hop_length
        )
        self.total_frames = int(sample_count / self.hop_length)
        if (sample_count - self.total_frames * self.hop_length) < self.frame_length:
            if self.total_frames > 1:
                self.total_frames -= 1

    def _in_lower_window(self, i: int) -> bool:
        return self.lwin_start_idx <= i <= self.lwin_end_idx

    def _in_upper_window(self, i: int) -> bool:
        if self.hwin_start_idx == self.lwin_end_idx:
            return False
        return self.hwin_start_idx <= i <= self.hwin_end_idx

    # ------------------------------------------------------------------
    def process_audio_frame(self, audio_data: np.ndarray) -> np.ndarray:
        frame = audio_data[: self.frame_length]
        if self.apply_window:
            k = np.arange(self.frame_length)
            frame = frame * (0.5 - 0.5 * np.cos(2 * np.pi * k / self.frame_length))
        spectrum = np.abs(np.fft.fft(frame))

        pft_spectrum = spectrum[self.pft_low_idx : self.pft_high_idx]
        peak_energy_index = int(np.argmax(pft_spectrum)) + self.pft_low_idx
        peak_energy = spectrum[peak_energy_index]
        if peak_energy != 0:
            self.peak_histogram[peak_energy_index] += 1
            self.freq_histogram[peak_energy_index] += peak_energy

        next_frame_time = self.ts_current + self.hop_length / self.fs
        next_pft_idx = int((next_frame_time % 60) / 2)
        pft_idx = int((self.ts_current % 60) / 2)
        peak_frequency_idx = int(np.argmax(self.peak_histogram))
        self.energy_histogram[self.loudness_bins + pft_idx] = peak_frequency_idx
        if next_pft_idx != pft_idx:
            self.peak_histogram.fill(0)

        drop_energy_level = float(
            np.sum(spectrum[self.rain_low_idx : self.rain_high_idx + 1])
        )
        if drop_energy_level > self.rain_energy_threshold:
            logbase = math.log(self.rain_log_base)
            rain_energy = (
                drop_energy_level - self.rain_energy_threshold
            ) * self.rain_log_factor
            histidx = math.floor(math.log(1 + rain_energy) / logbase)
            histidx = min(max(histidx, 0), self.loudness_bins - 1)
            self.energy_histogram[histidx] += 1

        audio_data = audio_data[self.hop_length :]
        self.frame_count += 1
        self.ts_current = self.ts_start + self.frame_count * self.hop_length / self.fs
        return audio_data

    def calculate_fft_energies(self) -> None:
        exp_pow_one = 2.719
        scale_freq = 25.0
        upper = 255
        for i in range(self.fft_n_bins):
            j = int(math.log(self.freq_histogram[i] + exp_pow_one) * scale_freq)
            j = min(j, upper)
            if self._in_lower_window(i):
                idx = self.loudness_bins + self.pft_bins + (i - self.lwin_start_idx)
                self.energy_histogram[idx] = int(j)
            if self._in_upper_window(i):
                idx = (
                    self.loudness_bins + self.pft_bins
                    + (i - self.hwin_start_idx) + self.fft_bins // 2
                )
                self.energy_histogram[idx] = int(j)

    def check_histogram_for_rain(self) -> bool:
        self.raining = bool(np.any(self.energy_histogram[: self.loudness_bins] != 0))
        return self.raining

    # ------------------------------------------------------------------
    def get_time_to_next_interval(self) -> float:
        t = self.rain_chk_period_seconds - (
            self.ts_current % self.rain_chk_period_seconds
        )
        if t < self.hop_length / self.fs:
            t += self.rain_chk_period_seconds
        return t

    def get_frames_to_next_interval(self, audio_data: np.ndarray) -> int:
        frames = int(self.get_time_to_next_interval() * self.fs / self.hop_length)
        frames_remaining = int(len(audio_data) / self.hop_length)
        if frames_remaining < frames:
            frames = frames_remaining
        if len(audio_data) < self.frame_length:
            frames = 0
        return frames

    def process_audio_upto_minute_boundary(self, audio_data: np.ndarray
                                           ) -> np.ndarray:
        frames = self.get_frames_to_next_interval(audio_data)
        for _ in range(frames):
            if len(audio_data) >= self.frame_length:
                audio_data = self.process_audio_frame(audio_data)
        self.calculate_fft_energies()
        return audio_data

    def get_next_raincheck_time(self) -> float:
        return (
            self.ts_current + self.get_time_to_next_interval()
            - self.rain_chk_duration_seconds
        )

    def process_audio_data(self, audio_data: np.ndarray, ts: float
                           ) -> List[np.ndarray]:
        """Per-minute 100-bin vectors with duty-cycled rain checking
        (``device_dsd_processing_emulator.py:256-314``)."""
        self.set_audio_timestamp(ts, len(audio_data))
        num_minutes = math.ceil(len(audio_data) / (self.fs * 60))
        output: List[np.ndarray] = []
        if len(audio_data) < self.frame_length:
            return output
        data_to_process = True
        for _ in range(num_minutes):
            self.clear_histogram()
            if self.raining:
                audio_data = self.process_audio_upto_minute_boundary(audio_data)
            else:
                rain_check_time = self.get_next_raincheck_time()
                while self.ts_current < rain_check_time:
                    audio_data = audio_data[self.hop_length :]
                    self.frame_count += 1
                    self.ts_current = (
                        self.ts_start + self.frame_count * self.hop_length / self.fs
                    )
                    if len(audio_data) < self.frame_length:
                        data_to_process = False
                        break
                if not data_to_process:
                    break
                self.clear_histogram()
                while self.ts_current < (
                    rain_check_time + self.rain_chk_duration_seconds
                ):
                    if len(audio_data) >= self.frame_length:
                        audio_data = self.process_audio_frame(audio_data)
                    else:
                        data_to_process = False
                        break
                if not data_to_process:
                    break
            self.check_histogram_for_rain()
            output.append(self.energy_histogram.copy())
            self.clear_histogram()
            if (not data_to_process) or (len(audio_data) < self.frame_length):
                break
        return output


# Reference-misspelling compat alias (``DsdProcessingEmualtor``)
DsdProcessingEmualtor = DsdProcessingEmulator


def read_audio_file(audio_file: str, read_size: int, read_offset: int,
                    header_size: int = HEADER_SIZE,
                    bytes_per_sample: int = DEFAULT_BYTES_PER_SAMPLE) -> np.ndarray:
    """RAW/WAV loader parity (``device_dsd_processing_emulator.py:316-335``)."""
    if audio_file.lower().endswith(".wav"):
        from audio_processing_tools_tpu_torch.io.audio import load_wav, resample_poly

        y, sr = load_wav(audio_file)
        if y.ndim == 2:
            y = y.mean(axis=0)
        if sr != 11162:
            y = resample_poly(y, sr, 11162)
        audio = y
    else:
        with open(audio_file, "rb") as f:
            f.seek(header_size)
            raw = f.read()
        scale = 1 << (bytes_per_sample * 8 - 1)
        audio = np.frombuffer(raw[: len(raw) - len(raw) % 2], dtype=np.int16) / scale
    return audio[read_offset : read_offset + read_size]


# ---------------------------------------------------------------------------
# Vectorized fast path for fleet backfills (always-raining minutes)
# ---------------------------------------------------------------------------


def write_results(csv_file_name: str, csv_columns, data) -> None:
    """Minute-vector CSV writer (reference
    ``device_dsd_processing_emulator.py:370-375``)."""
    import csv

    with open(csv_file_name, mode="w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=csv_columns)
        writer.writeheader()
        for row in data:
            writer.writerow(row)


def plot_data(val, duration, title, ax=None):
    """Simple waveform/series panel (reference ``:337-368`` headless form)."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(figsize=(10, 3))
    t = np.linspace(0.0, float(duration), len(val))
    ax.plot(t, np.asarray(val), linewidth=0.7)
    ax.set_title(title)
    ax.set_xlabel("time (s)")
    return ax


def dsd_minutes_vectorized(audio: np.ndarray, fs: int = 11162,
                           frame_length: int = 512, ts: float = 0.0
                           ) -> np.ndarray:
    """Vectorized per-minute DSD vectors for the no-duty-cycle case.

    Bit-equal to :class:`DsdProcessingEmulator` when ``raining`` stays True
    for the whole recording (the common case for backfills of rain-labeled
    clips, cf. ``transform.process_audio_file_dsd`` truncating to the first
    60 s).  Minute boundaries follow the frame-count arithmetic of the
    device (frames to next interval computed from ``ts``).
    """
    emu = DsdProcessingEmulator(fs, frame_length, frame_length, False, 0)
    emu.set_audio_timestamp(ts, len(audio))

    outputs = []
    pos = 0
    while True:
        n_left = len(audio) - pos
        frames = emu.get_frames_to_next_interval(audio[pos:])
        if frames <= 0 or n_left < frame_length:
            break
        end = pos + frames * frame_length
        usable = audio[pos : min(end, len(audio))]
        n_frames = len(usable) // frame_length
        if n_frames <= 0:
            break
        F = usable[: n_frames * frame_length].reshape(n_frames, frame_length)
        spec = np.abs(np.fft.fft(F, axis=-1))  # (n_frames, frame_length)

        # loudness histogram (vectorized)
        drop_e = spec[:, emu.rain_low_idx : emu.rain_high_idx + 1].sum(axis=-1)
        above = drop_e > emu.rain_energy_threshold
        logbase = math.log(emu.rain_log_base)
        rain_e = (drop_e - emu.rain_energy_threshold) * emu.rain_log_factor
        hist_idx = np.floor(
            np.log1p(np.maximum(rain_e, 0.0)) / logbase
        ).astype(np.int64)
        hist_idx = np.clip(hist_idx, 0, emu.loudness_bins - 1)
        loudness = np.bincount(
            hist_idx[above], minlength=emu.loudness_bins
        )[: emu.loudness_bins].astype(np.float64)

        # pft + fft histograms need the sequential 2-s slot semantics: reuse
        # the scalar path for those but with precomputed spectra
        vec = np.zeros(emu.loudness_bins + emu.pft_bins + emu.fft_bins)
        vec[: emu.loudness_bins] = loudness
        peak_hist = np.zeros(emu.fft_n_bins)
        freq_hist = np.zeros(emu.fft_n_bins)
        ts_cur = emu.ts_current
        fc = emu.frame_count
        for i in range(n_frames):
            s = spec[i]
            pft_s = s[emu.pft_low_idx : emu.pft_high_idx]
            pk = int(np.argmax(pft_s)) + emu.pft_low_idx
            if s[pk] != 0:
                peak_hist[pk] += 1
                freq_hist[pk] += s[pk]
            nxt = ts_cur + frame_length / fs
            pft_idx = int((ts_cur % 60) / 2)
            vec[emu.loudness_bins + pft_idx] = int(np.argmax(peak_hist))
            if int((nxt % 60) / 2) != pft_idx:
                peak_hist.fill(0)
            fc += 1
            ts_cur = emu.ts_start + fc * frame_length / fs
        emu.frame_count = fc
        emu.ts_current = ts_cur

        for i in range(emu.fft_n_bins):
            j = min(int(math.log(freq_hist[i] + 2.719) * 25.0), 255)
            if emu._in_lower_window(i):
                vec[emu.loudness_bins + emu.pft_bins + (i - emu.lwin_start_idx)] = j
            if emu._in_upper_window(i):
                vec[
                    emu.loudness_bins + emu.pft_bins
                    + (i - emu.hwin_start_idx) + emu.fft_bins // 2
                ] = j

        outputs.append(vec)
        pos = pos + n_frames * frame_length
        if len(audio) - pos < frame_length:
            break
    return np.asarray(outputs)
