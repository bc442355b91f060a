"""Engine configuration, NumPy-only.

Counterpart of ``audio_processing_tools_tpu/config.py:27-195``: the same
``NoiseConfig`` dataclass, the same ``build_noise_config`` precedence
(flat overrides > nested ``suppressor`` / ``detector`` dicts > defaults) and
the same ``dget`` / ``dflag`` detector-parameter lookup.  The copy exists
because importing anything from the JAX package imports JAX, and the port
runs where JAX is not installed.

The system has no learned weights: a config plus the filter constants it
designs is the whole state, so :func:`from_jax_config` carries a JAX
engine's state across.
"""

from __future__ import annotations

import copy
import json
from dataclasses import dataclass, field, fields
from typing import Any, Dict, Tuple

import numpy as np


@dataclass
class NoiseConfig:
    # Core
    fs: int = 11162
    n_fft: int = 256
    hop: int = 128

    # Pre-filter
    hp_cutoff_hz: float = 350.0
    hp_order: int = 4
    pre_filter_mode: str = "highpass"  # "highpass" | "bandpass" | "none"
    bp_order: int = 4

    # Operating band
    operating_band: Tuple[float, float] = (400.0, 3500.0)

    # Noise tracking
    q: float = 0.25
    win_sec: float = 0.5
    adaptive_q_enable: bool = False
    adaptive_q_min: float = 0.10
    adaptive_q_alpha: float = 0.95
    median_frames: int = 0
    eps: float = 1e-9
    noise_psd_max_ratio: float = 1.0
    use_lagged_noise_psd: bool = False

    # Oversubtraction / gain
    oversub_base: float = 1.0
    oversub_max: float = 3.0
    gain_floor: float = 0.0
    gain_ceil: float = 1.0
    gain_mode: str = "sqrt_sub"  # or "wiener"
    gain_smooth_alpha: float = 0.7
    adaptive_gain_enable: bool = True
    gain_freq_smooth_enable: bool = True
    gain_freq_kernel: Tuple[float, ...] = (0.2, 0.6, 0.2)
    pre_smooth_frames: int = 0
    ema_up: float = 0.6
    ema_down: float = 0.95

    # SNR gating
    snr_gating_enable: bool = False
    snr_gating_snr1: float = 1.0
    snr_gating_power: float = 1.0
    snr_gating_use_mode_bands: bool = True

    # Detector input normalization
    detector_use_noise_norm: bool = True
    detector_noise_norm_mode: str = "log_sub"  # or "ratio_db"

    # Mode switches
    suppressor_bypass: bool = False
    classifier_only_mode: bool = False

    # Debug / payload retention
    debug_enable: bool = False
    debug_frame_decim: int = 1
    dump_features: bool = False
    feature_decim: int = 1
    process_dtype: str = "float32"
    compute_output_audio: bool = False
    return_filtered_audio: bool = False
    return_debug: bool = False
    return_detector_debug: bool = False
    return_spectra: bool = False
    return_noise_psd: bool = False

    # Nested
    suppressor: Dict[str, Any] = field(default_factory=dict)
    detector: Dict[str, Any] = field(default_factory=dict)

    # ------------------------------------------------------------------
    def dget(self, name: str, default: Any = None) -> Any:
        """Detector-param precedence: detector dict > flat attr > default."""
        if isinstance(self.detector, dict) and name in self.detector:
            return self.detector[name]
        if hasattr(self, name):
            return getattr(self, name)
        return default

    def dflag(self, name: str, default: bool = False) -> bool:
        return bool(self.dget(name, default))

    def cache_key(self) -> str:
        """Canonical key of the configuration."""
        d = {f.name: getattr(self, f.name) for f in fields(self)}
        return json.dumps(d, sort_keys=True, default=str)

    # ------------------------------------------------------------------
    def validate(self) -> None:
        """Suppressor + detector validation (``config.py:117-145``)."""
        op_lo, op_hi = self.operating_band
        if not (np.isfinite(op_lo) and np.isfinite(op_hi) and 0.0 < float(op_lo) < float(op_hi)):
            raise ValueError(f"Invalid operating_band: {self.operating_band!r}")
        if int(self.n_fft) <= 0 or int(self.hop) <= 0:
            raise ValueError(f"Invalid STFT params n_fft={self.n_fft}, hop={self.hop}")
        if int(self.hop) > int(self.n_fft):
            raise ValueError(f"hop ({self.hop}) should not exceed n_fft ({self.n_fft})")
        if not (0.0 <= float(self.gain_floor) <= float(self.gain_ceil) <= 1.0):
            raise ValueError(
                f"Invalid gain bounds: floor={self.gain_floor}, ceil={self.gain_ceil}"
            )
        if float(self.oversub_base) <= 0.0 or float(self.oversub_max) <= 0.0:
            raise ValueError(
                f"Invalid oversub params: base={self.oversub_base}, max={self.oversub_max}"
            )
        if float(self.oversub_max) < float(self.oversub_base):
            raise ValueError(
                f"oversub_max ({self.oversub_max}) must be >= oversub_base ({self.oversub_base})"
            )
        if not (0.0 <= float(self.gain_smooth_alpha) <= 1.0):
            raise ValueError(f"Invalid gain_smooth_alpha: {self.gain_smooth_alpha}")
        if self.dget("mode_bands", None) is None:
            raise AttributeError(
                "Missing required detector field 'mode_bands'. Provide it under "
                "cfg.detector (preferred) or as a flat attribute."
            )


def build_noise_config(sample_rate: int, params: Dict[str, Any]) -> NoiseConfig:
    """Build a :class:`NoiseConfig` from framework params
    (``config.py:148-186``).  Legacy ``fmin``/``fmax`` are normalized into
    ``operating_band``."""
    cfg = NoiseConfig(fs=int(sample_rate))
    cfg_fields = {f.name for f in fields(NoiseConfig)}

    params = dict(params)

    sup = params.get("suppressor", None)
    if isinstance(sup, dict):
        cfg.suppressor = dict(sup)
        params = {**sup, **params}

    det = params.get("detector", None)
    if isinstance(det, dict):
        cfg.detector = dict(det)

    if "operating_band" not in params:
        fmin = params.get("fmin", None)
        fmax = params.get("fmax", None)
        if fmin is not None and fmax is not None:
            params["operating_band"] = (float(fmin), float(fmax))

    for k, v in params.items():
        if k not in cfg_fields:
            continue
        if k == "operating_band" and isinstance(v, (list, tuple)) and len(v) == 2:
            v = (float(v[0]), float(v[1]))
        if k == "gain_freq_kernel":
            v = tuple(float(x) for x in v)
        setattr(cfg, k, v)

    op_lo, op_hi = cfg.operating_band
    cfg.operating_band = (float(op_lo), float(op_hi))
    return cfg


def from_jax_config(d: Dict[str, Any]) -> NoiseConfig:
    """``NoiseConfig`` from ``dataclasses.asdict`` of the JAX package's config.

    Every field is carried over as it is; a key this dataclass does not have
    raises, so a config never loses a setting silently.
    """
    names = {f.name for f in fields(NoiseConfig)}
    unknown = sorted(set(d) - names)
    if unknown:
        raise ValueError(f"unknown NoiseConfig fields: {unknown}")
    return NoiseConfig(**{k: copy.deepcopy(v) for k, v in d.items()})


DEFAULT_MODE_BANDS = (
    (450.0, 650.0),
    (800.0, 1050.0),
    (1500.0, 1800.0),
    (2350.0, 2550.0),
    (3150.0, 3350.0),
)
