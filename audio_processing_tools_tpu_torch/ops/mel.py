"""Mel filterbank and band-energy features.

Counterpart of ``audio_processing_tools_tpu/ops/mel.py``.  The scale and
filterbank helpers (``hz_to_mel``, ``mel_to_hz``, ``mel_filterbank``,
``:24-93``) are float64 NumPy on the host, copied as they are (librosa
semantics: Slaney mel scale, triangular filters, Slaney area
normalization).  :func:`mel_spectrogram` runs kernel K1 through
:func:`~audio_processing_tools_tpu_torch.ops.spectrogram.spectrogram_power`
and applies the filterbank with one float32 matrix product (the JAX
package's ``einsum`` at ``Precision.HIGHEST``, outside any Pallas kernel;
TF32 is off, pinned at package import).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from audio_processing_tools_tpu_torch.ops._device import device_constant
from audio_processing_tools_tpu_torch.ops.spectrogram import spectrogram_power
from audio_processing_tools_tpu_torch.ops.stft import fft_frequencies


def hz_to_mel(f, htk: bool = False):
    """Hz -> mel (Slaney default, HTK optional); librosa parity."""
    f = np.asanyarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    if np.ndim(f):
        log_t = f >= min_log_hz
        mels = np.where(
            log_t,
            min_log_mel + np.log(np.maximum(f, min_log_hz) / min_log_hz) / logstep,
            mels,
        )
    elif f >= min_log_hz:
        mels = min_log_mel + np.log(f / min_log_hz) / logstep
    return mels


def mel_to_hz(m, htk: bool = False):
    """mel -> Hz; librosa parity."""
    m = np.asanyarray(m, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    if np.ndim(m):
        log_t = m >= min_log_mel
        freqs = np.where(
            log_t, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs
        )
    elif m >= min_log_mel:
        freqs = min_log_hz * np.exp(logstep * (m - min_log_mel))
    return freqs


def mel_filterbank(sr: int, n_fft: int, n_mels: int = 40,
                   fmin: float = 0.0, fmax: Optional[float] = None,
                   htk: bool = False, norm: Optional[str] = "slaney"
                   ) -> np.ndarray:
    """(n_mels, 1 + n_fft//2) triangular filterbank, float64;
    ``librosa.filters.mel`` parity."""
    if fmax is None:
        fmax = float(sr) / 2
    fft_freqs = fft_frequencies(sr, n_fft)
    mel_pts = mel_to_hz(
        np.linspace(hz_to_mel(fmin, htk), hz_to_mel(fmax, htk), n_mels + 2),
        htk,
    )
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fft_freqs[None, :]

    weights = np.zeros((n_mels, len(fft_freqs)))
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0, np.minimum(lower, upper))

    if norm == "slaney":
        enorm = 2.0 / (mel_pts[2 : n_mels + 2] - mel_pts[:n_mels])
        weights *= enorm[:, None]
    elif norm is not None:
        raise ValueError(f"unsupported norm {norm!r}")
    return weights


def mel_spectrogram(x: torch.Tensor, *, sr: int = 11162, n_fft: int = 256,
                    hop: int = 128, n_mels: int = 40, fmin: float = 0.0,
                    fmax: Optional[float] = None, htk: bool = False,
                    log: bool = False) -> torch.Tensor:
    """Mel power spectrogram ``(..., n_mels, T)``: K1's power spectrogram
    (its plain version on a CPU tensor), then the filterbank product.
    ``log=True`` returns dB (10 log10, floored at 1e-10)."""
    P = spectrogram_power(x, n_fft=n_fft, hop=hop)  # (..., F, T)
    fb = device_constant(("mel", sr, n_fft, n_mels, fmin, fmax, htk), P.device,
                         lambda: mel_filterbank(sr, n_fft, n_mels, fmin, fmax, htk))
    M = torch.matmul(fb, P)
    if log:
        M = 10.0 * torch.log10(torch.clamp_min(M, 1e-10))
    return M


def band_energies(P: torch.Tensor, freqs: np.ndarray, bands, db: bool = False,
                  eps: float = 1e-10) -> torch.Tensor:
    """Spectrogram power summed over (lo, hi) bands -> (..., n_bands, T), one
    product with the static 0/1 selection matrix."""
    sel = device_constant(
        ("bands", np.asarray(freqs, np.float64).tobytes(), tuple(map(tuple, bands))), P.device,
        lambda: np.stack([((freqs >= lo) & (freqs <= hi)) for lo, hi in bands]))
    E = torch.matmul(sel, P)
    if db:
        E = 10.0 * torch.log10(torch.clamp_min(E, eps))
    return E
