"""WAV input for the live server's file client.

Counterpart of ``audio_processing_tools_tpu/io/audio.py::load_wav``
(``:76-96``), copied: the card's machine has no JAX, so the port cannot
import the JAX package's module.  Standard library ``wave`` only.
"""

from __future__ import annotations

import wave

import numpy as np


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
