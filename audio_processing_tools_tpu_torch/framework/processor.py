"""Processor contract + concrete adapters.

Counterpart of ``audio_processing_tools_tpu/framework/processor.py``
(pandas-free); ``NoiseProcessor`` runs the port's ``SpectralNoiseEngine``
on ``device`` (the card unless the caller asks for the CPU).  Parity
targets: ``AudioProcessor`` protocol
(``audio_processing_framework.py:52-100``), ``BaseProcessor`` /
``RainProcessor`` (``processors.py:29-142``), ``NoiseProcessor``
(``noise_processor.py:15-129`` — rebuilt on the new engine, fixing the
reference's assumption that optional engine payloads are always present).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Protocol, Tuple, runtime_checkable

import numpy as np


@runtime_checkable
class AudioProcessor(Protocol):
    """A processor maps (audio, params) -> (scalar results, state)."""

    @property
    def name(self) -> str: ...

    def run(self, audio_data: np.ndarray, params: Dict[str, Any]
            ) -> Tuple[Dict[str, Any], Dict[str, Any]]: ...


@dataclass
class BaseProcessor:
    """Validation + timing helpers shared by concrete processors."""

    name: str

    def _validate_audio(self, audio_data: np.ndarray, params: Dict[str, Any]) -> None:
        if not isinstance(audio_data, np.ndarray):
            raise TypeError(f"audio_data must be a NumPy array, got {type(audio_data)}")
        if audio_data.ndim != 1:
            raise ValueError(f"audio_data must be 1-D, got shape {audio_data.shape}")
        sr = params.get("sample_rate")
        dur = params.get("check_duration")
        if sr is not None and dur is not None:
            min_len = int(sr * dur)
            if audio_data.size < min_len:
                raise ValueError(
                    f"audio_data too short: {audio_data.size} < required {min_len} samples"
                )

    def _with_timing(self, func: Callable[..., Any], *args, **kwargs) -> Tuple[Any, float]:
        t0 = time.perf_counter()
        result = func(*args, **kwargs)
        return result, time.perf_counter() - t0


@dataclass
class RainProcessor(BaseProcessor):
    """Adapter over a ``fn(audio, **params) -> (drops, frain_mean, state)``
    rain algorithm (e.g. the legacy RoE classifier)."""

    fn: Callable[..., Tuple[int, float, Dict[str, Any]]] = None

    def run(self, audio_data: np.ndarray, params: Dict[str, Any]
            ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        self._validate_audio(audio_data, params)
        (rain_drops, frain_mean, state), latency = self._with_timing(
            self.fn, audio_data, **params
        )
        results: Dict[str, Any] = {
            "rain_drops": rain_drops,
            "frain_mean": frain_mean,
            "latency_s": latency,
        }
        if isinstance(state, dict):
            for k in ("rain_drop_count", "rain_peaks_count", "rain_drop_count_mod"):
                if k in state:
                    results[k] = state[k]
        state_out: Dict[str, Any] = dict(state) if isinstance(state, dict) else {"state": state}
        state_out["processor"] = self.name
        state_out["latency_s"] = latency
        return results, state_out


@dataclass
class NoiseProcessor(BaseProcessor):
    """Framework noise processor wrapping the spectral engine.

    Returns band-limited noise-floor statistics and the rain-frame fraction;
    rich engine state goes to the per-file state dict.  The engine runs on
    ``device``.
    """

    device: str = "cuda"

    def run(self, audio_data: np.ndarray, params: Dict[str, Any]
            ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        from audio_processing_tools_tpu_torch.config import build_noise_config
        from audio_processing_tools_tpu_torch.models.frame_classifier import FrameClass
        from audio_processing_tools_tpu_torch.models.spectral_noise import SpectralNoiseEngine

        self._validate_audio(audio_data, params)
        sample_rate = int(params.get("sample_rate", 11162))

        p = dict(params)
        p.setdefault("return_noise_psd", True)
        cfg = build_noise_config(sample_rate, p)
        eng = SpectralNoiseEngine(cfg, device=self.device)

        t0 = time.perf_counter()
        out = eng.process(audio_data, sr=sample_rate)
        latency = time.perf_counter() - t0

        is_rain = np.asarray(out["frame_class"]) == int(FrameClass.RAIN)
        metrics: Dict[str, Any] = {
            "rain_frame_fraction": float(is_rain.mean()) if is_rain.size else 0.0,
            "latency_s": latency,
        }
        if "mean_noise_floor_db" in out:
            metrics["mean_noise_floor_db"] = float(out["mean_noise_floor_db"])
            metrics["median_noise_floor_db"] = float(out["median_noise_floor_db"])

        state: Dict[str, Any] = {
            "frame_class": out.get("frame_class"),
            "is_rain": is_rain,
            "times": out.get("times"),
            "noise_psd": out.get("noise_psd"),
            "config": cfg,
            "processor": self.name,
            "latency_s": latency,
        }
        for k in ("y", "S", "S_hat", "debug", "x_filt"):
            if k in out:
                state[k] = out[k]
        return metrics, state


def has_processor(processors, name: str) -> bool:
    """True if any processor in the list has ``p.name == name``."""
    return any(p.name == name for p in processors)
