"""The spectral engine's configuration, NumPy-free.

Counterpart of ``audio_processing_tools_tpu/config.py:27-195``: the same
``NoiseConfig`` dataclass and defaults, the flat and ``detector``
parameters of ``build_noise_config``, and the same ``dget``
detector-parameter lookup.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields
from typing import Any, Dict, Tuple


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


def build_noise_config(sample_rate: int, params: Dict[str, Any]) -> NoiseConfig:
    """A :class:`NoiseConfig` from the step's parameters (``config.py:148-186``):
    flat keys set fields, ``detector`` holds the detector's.  The nested
    ``suppressor`` dict and legacy ``fmin`` / ``fmax`` are not implemented."""
    left = {"suppressor", "fmin", "fmax"} & set(params)
    if left:
        raise NotImplementedError(f"the spectral reference does not take {sorted(left)}")
    cfg = NoiseConfig(fs=int(sample_rate))
    names = {f.name for f in fields(NoiseConfig)}
    for k, v in params.items():
        if k in names:
            setattr(cfg, k, tuple(v) if isinstance(v, list) else v)
    return cfg
