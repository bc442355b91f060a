"""Waveform / FFT / spectrogram plots (parity with ``visualize_audio.py``).

Counterpart of ``audio_processing_tools_tpu/viz/visualize_audio.py``;
matplotlib is imported inside each function.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def plot_audio_signal(sig, sample_rate: int, title: str = "Audio Signal",
                      ax=None):
    """Time-series waveform plot (``visualize_audio.py:7-52``)."""
    import matplotlib.pyplot as plt

    sig = np.asarray(sig)
    t = np.arange(sig.size) / float(sample_rate)
    if ax is None:
        _, ax = plt.subplots(figsize=(10, 3))
    ax.plot(t, sig, linewidth=0.5)
    ax.set_xlabel("Time (s)")
    ax.set_ylabel("Amplitude")
    ax.set_title(title)
    ax.grid(True, alpha=0.3)
    return ax.figure


def plot_audio_fft(sig, sample_rate: int, title: str = "FFT", ax=None):
    """Single-sided amplitude spectrum (``visualize_audio.py:55-67``)."""
    import matplotlib.pyplot as plt

    sig = np.asarray(sig)
    n = sig.size
    amp = 2.0 / n * np.abs(np.fft.fft(sig)[: n // 2])
    freqs = np.fft.fftfreq(n, 1.0 / sample_rate)[: n // 2]
    if ax is None:
        _, ax = plt.subplots(figsize=(10, 3))
    ax.plot(freqs, amp, linewidth=0.7)
    ax.set_xlabel("Frequency (Hz)")
    ax.set_ylabel("Amplitude")
    ax.set_title(title)
    ax.grid(True, alpha=0.3)
    return ax.figure


def plot_audio_spectrogram(sig, sample_rate: int, n_fft: int = 256,
                           hop: Optional[int] = None, db_floor: float = -80.0,
                           title: str = "Spectrogram", ax=None):
    """dB spectrogram heatmap with a floor (``visualize_audio.py:69-142``)."""
    import matplotlib.pyplot as plt
    import scipy.signal as spsig

    sig = np.asarray(sig, np.float64)
    hop = hop or n_fft // 2
    freqs, times, sxx = spsig.spectrogram(
        sig, fs=sample_rate, window="hann", nperseg=n_fft,
        noverlap=n_fft - hop, mode="psd",
    )
    sxx_db = 10.0 * np.log10(np.maximum(sxx, 1e-12))
    sxx_db = np.maximum(sxx_db, db_floor)
    if ax is None:
        _, ax = plt.subplots(figsize=(10, 4))
    pcm = ax.pcolormesh(times, freqs, sxx_db, shading="auto", cmap="magma")
    ax.set_xlabel("Time (s)")
    ax.set_ylabel("Frequency (Hz)")
    ax.set_title(title)
    ax.figure.colorbar(pcm, ax=ax, label="dB")
    return ax.figure


# name parity with the reference (``visualize_audio.py:55``)
plot_fft = plot_audio_fft
