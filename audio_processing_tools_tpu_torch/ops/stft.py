"""STFT / ISTFT with librosa-parity semantics, batched over leading axes.

Counterpart of ``audio_processing_tools_tpu/ops/stft.py:36-148``:

  * periodic Hann window,
  * ``center=True`` pads ``n_fft // 2`` zeros on both sides
    (``pad_mode="constant"``, ``:46-53``),
  * ``T = 1 + n // hop`` frames when centered,
  * output layout ``(..., F, T)`` with ``F = 1 + n_fft // 2``,
  * :func:`istft` is windowed overlap-add normalized by the summed squared
    window, trimmed by ``n_fft // 2`` and cut or padded to ``length``.

:func:`stft_power` is the plain version of the hand-written spectrogram
kernel (``ops/spectrogram.py``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as tnf

from audio_processing_tools_tpu_torch.ops._device import device_constant
from audio_processing_tools_tpu_torch.ops.framing import frame_signal
from audio_processing_tools_tpu_torch.ops.windows import analysis_window, hann_window


def fft_frequencies(sr: float, n_fft: int) -> np.ndarray:
    """Bin center frequencies; matches ``librosa.fft_frequencies``."""
    return np.linspace(0.0, float(sr) / 2.0, 1 + n_fft // 2, dtype=np.float64)


def frames_to_time(frames: np.ndarray, sr: float, hop: int) -> np.ndarray:
    """Frame index -> seconds; matches ``librosa.frames_to_time``."""
    return np.asarray(frames, dtype=np.float64) * (float(hop) / float(sr))


def _pad_center(x: torch.Tensor, n_fft: int, pad_mode: str) -> torch.Tensor:
    if pad_mode != "constant":
        raise ValueError(f"unsupported pad_mode {pad_mode!r}")
    pad = n_fft // 2
    return tnf.pad(x, (pad, pad))


def stft(x: torch.Tensor, n_fft: int = 256, hop: int = 128,
         center: bool = True, pad_mode: str = "constant",
         window: str = "hann") -> torch.Tensor:
    """Complex STFT of the last axis: ``(..., 1 + n_fft//2, T)``, with the
    periodic Hann window or, ``window="rect"``, none."""
    x = x.to(torch.float32)
    if center:
        x = _pad_center(x, n_fft, pad_mode)
    frames = frame_signal(x, n_fft, hop)  # (..., T, n_fft)
    if window != "rect":
        frames = frames * device_constant((window, n_fft), x.device,
                                          lambda: analysis_window(window, n_fft))
    spec = torch.fft.rfft(frames, dim=-1)  # (..., T, F)
    return spec.transpose(-1, -2)


def stft_power(x: torch.Tensor, n_fft: int = 256, hop: int = 128,
               center: bool = True, pad_mode: str = "constant",
               window: str = "hann") -> torch.Tensor:
    """``|STFT|^2`` as float32 ``(..., F, T)``, contiguous."""
    s = stft(x, n_fft=n_fft, hop=hop, center=center, pad_mode=pad_mode, window=window)
    return (s.real * s.real + s.imag * s.imag).contiguous()


def _istft_wsq(n_fft: int, hop: int, T: int) -> np.ndarray:
    """Summed squared window of the overlap-add, in float64 on the host, with
    near-zero sums set to 1 (``stft.py:133-137``)."""
    w = hann_window(n_fft).astype(np.float64)
    idx = (np.arange(T)[:, None] * hop + np.arange(n_fft)[None, :]).reshape(-1)
    wsq = np.zeros((T - 1) * hop + n_fft, dtype=np.float64)
    np.add.at(wsq, idx, np.tile(w ** 2, T))
    return np.where(wsq > 1e-10, wsq, 1.0)


def istft(S: torch.Tensor, n_fft: int = 256, hop: int = 128,
          length: int | None = None, center: bool = True) -> torch.Tensor:
    """Inverse STFT by windowed overlap-add (``stft.py:91-148``).

    ``S`` is ``(..., F, T)`` complex; returns ``(..., length)`` float32.
    When ``hop`` divides ``n_fft`` the overlap-add is ``n_fft // hop``
    shifted chunk adds, in the JAX package's order; otherwise one
    ``index_add_``.  The squared-window normalization is a float64 host
    constant rounded to float32, kept on the device.
    """
    F, T = S.shape[-2], S.shape[-1]
    if F != 1 + n_fft // 2:
        raise ValueError(f"S has {F} bins; expected {1 + n_fft // 2}")
    dev = S.device
    w = device_constant(("hann", n_fft), dev, lambda: hann_window(n_fft))
    frames = torch.fft.irfft(S.transpose(-1, -2), n=n_fft, dim=-1) * w  # (..., T, n_fft)

    total = (T - 1) * hop + n_fft
    lead = frames.shape[:-2]
    if n_fft % hop == 0:
        # frame t's k-th hop chunk lands on output block t + k
        m = n_fft // hop
        chunks = frames.reshape(lead + (T, m, hop))
        y = frames.new_zeros(lead + (T - 1 + m, hop))
        for k in range(m):
            y[..., k : k + T, :] += chunks[..., :, k, :]
        y = y.reshape(lead + (total,))
    else:
        idx = (torch.arange(T, device=dev)[:, None] * hop
               + torch.arange(n_fft, device=dev)[None, :]).reshape(-1)
        y = frames.new_zeros(lead + (total,))
        y.index_add_(-1, idx, frames.reshape(lead + (T * n_fft,)))

    y = y / device_constant(("istft_wsq", n_fft, hop, T), dev,
                            lambda: _istft_wsq(n_fft, hop, T))
    if center:
        y = y[..., n_fft // 2 :]
    if length is not None:
        y = y[..., :length] if length <= y.shape[-1] else tnf.pad(y, (0, length - y.shape[-1]))
    return y.to(torch.float32)
