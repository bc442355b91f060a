"""Mel-feature rain classifier.

Counterpart of ``audio_processing_tools_tpu/models/mel_classifier.py``
(``:38-208``): the power spectrogram (kernel K1) through the Slaney mel
filterbank, the mean dB energy of the mel bands whose centres lie in the
rain band, its 2-frame positive flux as the per-frame statistic, and a
high quantile of the flux as the clip score.  Everything runs on the
device of the batch; the band mean is a
:func:`~audio_processing_tools_tpu_torch.ops.stats.tree_sum` times the
band count's float32 reciprocal (XLA multiplies by the reciprocal where JAX
divides by a constant), so the CPU and the card give the same bits from
the same mel power.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from audio_processing_tools_tpu_torch.ops._device import f32, f32_recip
from audio_processing_tools_tpu_torch.ops.mel import hz_to_mel, mel_spectrogram, mel_to_hz
from audio_processing_tools_tpu_torch.ops.stats import quantile_linear, tree_sum


@dataclass(frozen=True)
class MelClassifierConfig:
    """Constants of one classifier (``mel_classifier.py:38-60``)."""

    sample_rate: int = 11162
    n_fft: int = 256
    hop: int = 128
    n_mels: int = 40
    band_lo_hz: float = 450.0
    band_hi_hz: float = 2600.0
    frame_flux_db: float = 6.0      # per-frame rain decision threshold
    clip_quantile: float = 0.98     # clip score = this quantile of the flux
    clip_threshold_db: float = 12.0  # clip is rain above this score
    eps: float = 1e-9

    def validate(self) -> None:
        if not 0.0 < self.clip_quantile <= 1.0:
            raise ValueError(f"clip_quantile must be in (0, 1], got "
                             f"{self.clip_quantile}")
        if self.band_hi_hz <= self.band_lo_hz:
            raise ValueError("band_hi_hz must exceed band_lo_hz")
        if self.n_mels < 4:
            raise ValueError("n_mels must be >= 4")


def build_mel_config(params: Dict[str, Any]) -> MelClassifierConfig:
    """Flat params > nested ``params['mel']`` > defaults."""
    nested = dict(params.get("mel", {}) or {})
    kw = {}
    for f in MelClassifierConfig.__dataclass_fields__:
        if f in params:
            kw[f] = params[f]
        elif f in nested:
            kw[f] = nested[f]
    cfg = MelClassifierConfig(**kw)
    cfg.validate()
    return cfg


class MelRainClassifier:
    """Waveform batch -> mel dB band flux -> frame mask and clip verdict, on
    ``device`` (the card unless the caller asks for the CPU)."""

    def __init__(self, config: Optional[MelClassifierConfig] = None,
                 device: str | torch.device = "cuda"):
        self.cfg = config
        self.device = torch.device(device)

    def setup(self, params: Dict[str, Any]) -> None:
        if self.cfg is None:
            self.cfg = build_mel_config(params)

    def _band_mask(self) -> np.ndarray:
        cfg = self.cfg
        centers = mel_to_hz(np.linspace(
            hz_to_mel(0.0), hz_to_mel(cfg.sample_rate / 2), cfg.n_mels + 2
        ))[1:-1]
        mask = (centers >= cfg.band_lo_hz) & (centers <= cfg.band_hi_hz)
        if not mask.any():
            raise ValueError("mel band selection is empty")
        return mask

    def _run(self, xb: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``_traced`` (``mel_classifier.py:99-123``) on a (B, N) batch."""
        cfg = self.cfg
        dev = xb.device
        band = np.flatnonzero(self._band_mask())
        M = mel_spectrogram(xb, sr=cfg.sample_rate, n_fft=cfg.n_fft, hop=cfg.hop,
                            n_mels=cfg.n_mels)                       # (B, n_mels, T)
        M_db = 10.0 * torch.log10(M + f32(cfg.eps, dev))
        rows = M_db[:, torch.as_tensor(band, device=dev)]
        E = tree_sum(rows, dim=1) * f32_recip(band.size, dev)         # (B, T)
        T = E.shape[-1]
        flux = torch.zeros_like(E)
        if T > 2:
            flux[:, 2:] = torch.clamp_min(E[:, 2:] - E[:, :-2], 0.0)
        frame_is_rain = flux > f32(cfg.frame_flux_db, dev)
        score = quantile_linear(flux, cfg.clip_quantile, dim=-1)
        return {
            "band_energy_db": E,
            "mel_flux_db": flux,
            "frame_is_rain": frame_is_rain,
            "rain_frame_fraction": tree_sum(frame_is_rain.to(torch.float32), dim=-1)
            * f32_recip(T, dev),
            "clip_score_db": score,
            "clip_is_rain": score > f32(cfg.clip_threshold_db, dev),
        }

    def process_batch(self, xb, sr: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """(B, N) samples (NumPy or a tensor) -> dict of (B, ...) tensors on
        the classifier's device."""
        if self.cfg is None:
            self.setup({"sample_rate": sr or 11162})
        if not torch.is_tensor(xb):
            xb = torch.from_numpy(np.asarray(xb, np.float32))
        xb = xb.to(device=self.device, dtype=torch.float32)
        if xb.dim() != 2:
            raise ValueError(f"expected (B, N) batch, got {tuple(xb.shape)}")
        return self._run(xb)

    def process(self, x, sr: Optional[int] = None) -> Dict[str, torch.Tensor]:
        x = torch.as_tensor(np.asarray(x, np.float32) if not torch.is_tensor(x) else x)
        out = self.process_batch(x.reshape(1, -1), sr=sr)
        return {k: v[0] for k, v in out.items()}


def _to_numpy(out: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in out.items()}


class MelRainProcessor:
    """Framework adapter (``mel_classifier.py:145-208``): ``run`` for one
    clip, ``run_batch`` for a (B, N) batch, each returning ``(metrics,
    state)`` pairs; the classifier runs on ``device``."""

    def __init__(self, name: str = "mel_rain", device: str | torch.device = "cuda"):
        self.name = name
        self.device = torch.device(device)
        self._cache: Dict[str, MelRainClassifier] = {}

    def _engine(self, params: Dict[str, Any]) -> MelRainClassifier:
        try:
            key = json.dumps(params, sort_keys=True, default=str)
        except Exception:
            key = repr(sorted(params.items(), key=lambda kv: kv[0]))
        eng = self._cache.get(key)
        if eng is None:
            eng = MelRainClassifier(device=self.device)
            eng.setup(params)
            self._cache[key] = eng
        return eng

    @staticmethod
    def _pair(out_i: Dict[str, np.ndarray], latency: float, name: str
              ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        metrics = {
            "clip_is_rain": bool(out_i["clip_is_rain"]),
            "clip_score_db": float(out_i["clip_score_db"]),
            "rain_frame_fraction": float(out_i["rain_frame_fraction"]),
            "latency_s": latency,
        }
        state = {
            "frame_is_rain": np.asarray(out_i["frame_is_rain"]),
            "mel_flux_db": np.asarray(out_i["mel_flux_db"]),
            "band_energy_db": np.asarray(out_i["band_energy_db"]),
            **metrics,
            "processor": name,
        }
        return metrics, state

    def run(self, audio_data, params: Dict[str, Any]
            ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        audio_data = np.asarray(audio_data)
        if audio_data.ndim != 1:
            raise ValueError(f"audio_data must be 1-D, got {audio_data.shape}")
        eng = self._engine(params)
        t0 = time.perf_counter()
        out = _to_numpy(eng.process(audio_data, sr=params.get("sample_rate")))
        return self._pair(out, time.perf_counter() - t0, self.name)

    def run_batch(self, audio_matrix, params: Dict[str, Any]) -> list:
        """(B, N) samples (NumPy or a tensor) -> one ``(metrics, state)`` pair
        per clip."""
        if not torch.is_tensor(audio_matrix):
            audio_matrix = np.asarray(audio_matrix, np.float32)
        if audio_matrix.ndim != 2:
            raise ValueError(f"audio_matrix must be 2-D, got {tuple(audio_matrix.shape)}")
        B = audio_matrix.shape[0]
        eng = self._engine(params)
        t0 = time.perf_counter()
        out = _to_numpy(eng.process_batch(audio_matrix, sr=params.get("sample_rate")))
        latency = (time.perf_counter() - t0) / max(B, 1)
        return [
            self._pair({k: v[i] for k, v in out.items()}, latency, self.name)
            for i in range(B)
        ]
