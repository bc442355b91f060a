"""Wind/gust analysis companions of the legacy RoE classifier.

Counterpart of ``audio_processing_tools_tpu/models/wind.py``:

  * :func:`detect_gusts` / :func:`compare_novelties` /
    :func:`novelty_based_gust_detection`: wind-band against rain-band
    novelty, with the RoE novelty (``models/roe.py::_novelty_spectrum``) on
    ``device``;
  * :func:`compute_rain_mod`: the gust-normalized rain indicator;
  * :func:`analyze_energy_peaks`: the order-8 band-pass on ``device``
    (zero-state ``sosfilt``, kernel K4 on the card), then block energies
    and scipy's ``find_peaks`` with the pulse walk on the host, as the JAX
    package does;
  * :func:`compute_novelty_energy`, :func:`moving_average_smoothing`,
    :func:`check_energy_threshold`: NumPy, copied.

Results return as NumPy arrays.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import scipy.signal as spsig
import torch

from audio_processing_tools_tpu_torch.models.roe import _novelty_spectrum
from audio_processing_tools_tpu_torch.ops.filters import butter_sos, sosfilt
from audio_processing_tools_tpu_torch.ops.stft import fft_frequencies, frames_to_time


def detect_gusts(mag, Fs: int, wind_band=(200, 300), rain_band=(400, 700),
                 n_fft: int = 256, hop_length: int = 128,
                 threshold: float = 5, M: int = 20,
                 device: str | torch.device = "cuda"):
    """Wind-band vs rain-band novelty (``wind.py:29-53``) of a magnitude
    spectrogram (F, T).  Returns ``(gust_times, nov_wind_raw, nov_rain_raw,
    nov_wind, nov_rain)``."""
    mag = np.asarray(mag)
    freqs = fft_frequencies(Fs, n_fft)

    def band_novelty(band, thr):
        # the band's rows sliced and differenced within the slice
        rows = np.flatnonzero((freqs >= band[0]) & (freqs <= band[1]))
        Y = torch.as_tensor(np.asarray(mag[rows, :], np.float32), device=torch.device(device))
        nov_t, nov_raw = _novelty_spectrum(Y, M, thr)
        return nov_t.cpu().numpy(), nov_raw.cpu().numpy()

    nov_wind, nov_wind_raw = band_novelty(wind_band, 10.0)  # fixed wind thr
    nov_rain, nov_rain_raw = band_novelty(rain_band, threshold)

    times = frames_to_time(np.arange(nov_wind.shape[0]), Fs, hop_length)
    gust_times = times[nov_wind > 0]
    return gust_times, nov_wind_raw, nov_rain_raw, nov_wind, nov_rain


def compare_novelties(nov_wind_raw, nov_rain_raw, wind_mask, rain_mask
                      ) -> Dict[str, Any]:
    """Summary stats comparing wind vs rain novelty streams
    (``wind.py:56-74``)."""
    nov_wind_raw = np.asarray(nov_wind_raw)
    nov_rain_raw = np.asarray(nov_rain_raw)
    wind_mask = np.asarray(wind_mask)
    rain_mask = np.asarray(rain_mask)
    return {
        "wind_raw_max": float(np.max(nov_wind_raw)),
        "rain_raw_max": float(np.max(nov_rain_raw)),
        "wind_raw_mean": float(np.mean(nov_wind_raw)),
        "rain_raw_mean": float(np.mean(nov_rain_raw)),
        "wind_thresh_sum": float(np.sum(np.where(wind_mask, nov_wind_raw, 0))),
        "rain_thresh_sum": float(np.sum(np.where(rain_mask, nov_rain_raw, 0))),
        "wind_spike_count": int(np.sum(wind_mask > 0)),
        "rain_spike_count": int(np.sum(rain_mask > 0)),
        "overlap_spikes": int(np.sum((wind_mask > 0) & (rain_mask > 0))),
    }


def novelty_based_gust_detection(Y, Fs: int, frame_length: int = 256,
                                 hop_length: int = 128, duration: float = 10,
                                 wind_band=(150, 300), threshold: float = 4.25,
                                 M: int = 20, nov=None,
                                 device: str | torch.device = "cuda") -> Dict[str, Any]:
    """Gust-detection state payload (``wind.py:77-96``)."""
    gust_times, w_raw, r_raw, w_t, r_t = detect_gusts(
        Y, Fs, wind_band=wind_band, n_fft=frame_length,
        hop_length=hop_length, threshold=threshold, M=M, device=device,
    )
    comparison = compare_novelties(w_raw, r_raw, w_raw > 10, r_raw > 5)
    n_frames = len(nov[0]) if nov is not None else np.asarray(Y).shape[1]
    return {
        "nov_wind": w_t,
        "nov_rain": r_t,
        "nov_wind_raw": w_raw,
        "nov_rain_raw": r_raw,
        "gust_time": gust_times,
        "time_spec": np.linspace(0, duration, n_frames),
        "novelty_comparison": comparison,
    }


def compute_rain_mod(nov_rain, nov_gust, raining, rain_thr: float) -> np.ndarray:
    """Gust-normalized rain indicator (``wind.py:99-109``)."""
    nov_rain = np.asarray(nov_rain, np.float64)
    nov_gust = np.asarray(nov_gust, np.float64)
    raining = np.asarray(raining, np.float64)
    gust_safe = nov_gust.copy()
    gust_safe[gust_safe == 0] = np.nan
    ratio = nov_rain / gust_safe
    raining_mod = np.where(nov_gust > 0, ratio * raining, nov_rain * raining)
    raining_mod = np.nan_to_num(raining_mod)
    return np.where(raining_mod >= rain_thr, rain_thr, 0)


def analyze_energy_peaks(audio_data, Fs: int = 11162, freq_band=(60, 1500),
                         block_length: int = 48, tx_ms: float = 400,
                         peak_ratio_thr: float = 4.0, max_db_drop: float = 20,
                         device: str | torch.device = "cuda"
                         ) -> Tuple[List[Dict[str, Any]], np.ndarray, float]:
    """Block-energy pulse timing analysis (``wind.py:112-188``).

    Band-pass (float32 on ``device``) -> block energies -> sharp peaks (>=
    the peak ratio over the local minimum, within ``max_db_drop`` of the
    tallest) -> rise/decay edges, pulses longer than 50 ms rejected.
    Returns ``(pulses, energy, energy_fs)``.
    """
    x = torch.as_tensor(np.asarray(audio_data, np.float32), device=torch.device(device))
    nyq = 0.5 * Fs
    sos = butter_sos(8, [freq_band[0] / nyq, freq_band[1] / nyq], "bandpass")
    filtered = sosfilt(sos, x).cpu().numpy()

    num_blocks = len(filtered) // block_length
    energy = np.array([
        np.sum(filtered[i * block_length : (i + 1) * block_length] ** 2)
        for i in range(num_blocks)
    ])
    energy_fs = Fs / block_length
    ms_per_block = block_length / Fs * 1000
    half_tx = int((tx_ms / 2) / ms_per_block)
    total = len(energy)

    peaks, _ = spsig.find_peaks(energy)
    if peaks.size == 0:
        return [], energy, energy_fs

    max_db = 10 * np.log10(np.max(energy[peaks]) + 1e-12)
    valid = [p for p in peaks
             if 10 * np.log10(energy[p] + 1e-12) >= max_db - max_db_drop]
    ordered = sorted(valid, key=lambda i: energy[i], reverse=True)

    used = np.zeros(total, bool)
    results: List[Dict[str, Any]] = []
    for p in ordered:
        if used[p]:
            continue
        a = max(p - half_tx, 0)
        b = min(p + half_tx + 1, total)
        local_min = np.min(energy[a:b])
        if local_min <= 0 or energy[p] / local_min < peak_ratio_thr:
            continue
        end_idx = p
        for i in range(p + 1, b):
            if energy[i] <= 1.2 * local_min:
                end_idx = i
                break
        start_idx = p
        for i in range(p - 1, a - 1, -1):
            if energy[i] <= 1.2 * local_min:
                start_idx = i
                break
        rise_ms = (p - start_idx) * ms_per_block
        decay_ms = (end_idx - p) * ms_per_block
        pulse_ms = rise_ms + decay_ms
        if pulse_ms > 50:
            used[start_idx : end_idx + 1] = True
            continue
        offset = (block_length / (2 * Fs)) * 1000
        results.append({
            "peak_idx": int(p),
            "peak_time_ms": p * ms_per_block + offset,
            "peak_energy": float(energy[p]),
            "start_time_ms": start_idx * ms_per_block + offset,
            "end_time_ms": end_idx * ms_per_block + offset,
            "rise_time_ms": rise_ms,
            "decay_time_ms": decay_ms,
            "pulse_time": pulse_ms,
            "start_energy": float(energy[start_idx]),
            "end_energy": float(energy[end_idx]),
        })
        used[start_idx : end_idx + 1] = True
    return results, energy, energy_fs


def compute_novelty_energy(x, Fs: float = 1, N: int = 512, H: int = 256,
                           gamma: float = 10, norm: bool = True
                           ) -> Tuple[np.ndarray, float]:
    """Energy-based novelty function (``wind.py:191-210``): hann^2-smoothed
    local energy, optional log compression, positive diff, max-normalized
    then rescaled by the max energy."""
    x = np.asarray(x, np.float64)
    k = np.arange(N)
    w = 0.5 - 0.5 * np.cos(2 * np.pi * k / (N - 1))  # symmetric hann
    energy_local = np.convolve(x**2, w**2, "same")[::H]
    fs_feature = Fs / H
    max_energy = energy_local.max() if energy_local.size else 0.0
    if gamma is not None:
        energy_local = np.log(1 + gamma * energy_local)
    d = np.diff(energy_local)
    d = np.concatenate([d, [0.0]])
    novelty = np.where(d < 0, 0.0, d)
    if norm and novelty.max() > 0:
        novelty = novelty / novelty.max()
    return novelty * max_energy, fs_feature


def moving_average_smoothing(input_signal, k: int) -> np.ndarray:
    """Edge-padded moving average (``wind.py:213-223``)."""
    if k <= 0:
        raise ValueError(
            "The length of the moving average filter (k) must be a positive "
            "integer."
        )
    pad = k // 2
    padded = np.pad(np.asarray(input_signal, np.float64), (pad, pad),
                    mode="edge")
    return np.convolve(padded, np.ones(k) / k, mode="valid")


def check_energy_threshold(magnitude_spectrum, freqs, Fs: float, N: int,
                           threshold: float) -> bool:
    """Band-energy gate (``wind.py:226-233``)."""
    f_res = Fs / N
    idx1 = int(freqs[0] // f_res + 1)
    idx2 = int(freqs[1] // f_res)
    band = np.asarray(magnitude_spectrum)[idx1 : idx2 + 1]
    return bool(np.sum(np.square(band)) > threshold)
