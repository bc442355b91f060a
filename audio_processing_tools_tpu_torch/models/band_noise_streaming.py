"""Per-frame streaming API of the band-noise estimator (sensor-shaped).

Counterpart of ``audio_processing_tools_tpu/models/band_noise_streaming.py``:
the stateful per-frame classes of firmware deployment loops.
:class:`BandNoiseEstimator` calls :func:`band_noise_process_chunk` with one
frame and its carried state, so N frames streamed here give the bits of one
:func:`band_noise_process` call over their concatenation.
:class:`NoiseFrameDetector` is the standalone NumPy twin of the scan's frame
detector (FFT band-jump decision, subframe dB-rise mask with a hold), copied
as it is: the port imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from audio_processing_tools_tpu_torch.models.band_noise import (
    BandNoiseEstimatorConfig,
    NoiseFrameDetectorConfig,
    band_noise_init_state,
    band_noise_process_chunk,
    band_noise_reset_noise_estimator,
    db_to_ratio,
    hz_to_bin,
)

_EPS = 1e-12

# scan outputs that accumulate since the start vs per-frame gauges
_ACCUM_FIELDS = (
    "noise_energy_sum", "rain_energy_sum", "total_energy_sum",
    "noise_frame_count", "rain_frame_count", "total_frame_count",
    "noise_learned_subframe_count", "noise_replenish_count",
)
_GAUGE_FIELDS = (
    "noise_buffer_valid_count", "noise_buffer_min_valid_count",
    "noise_buffer_underflow_frame_count", "frames_since_noise_update",
    "noise_effective_q",
)


@dataclass
class BandNoiseFrameOut:
    """One frame's estimator output (``band_noise_streaming.py:49-78``)."""

    M_band: float
    E_band: float
    N_E: float
    N_E_raw: float
    N_sub: np.ndarray
    subE: np.ndarray
    rain_submask: np.ndarray
    G_mag: float
    M_clean: float
    fft_rain_frame: bool
    M_band_fft: float = 0.0
    E_band_fft: float = 0.0
    E_hpf: float = 0.0
    noise_energy_sum: float = 0.0
    rain_energy_sum: float = 0.0
    total_energy_sum: float = 0.0
    noise_frame_count: int = 0
    rain_frame_count: int = 0
    total_frame_count: int = 0
    noise_buffer_valid_count: int = 0
    noise_buffer_min_valid_count: int = 0
    noise_buffer_underflow_frame_count: int = 0
    frames_since_noise_update: int = 0
    noise_learned_subframe_count: int = 0
    noise_replenish_count: int = 0
    noise_effective_q: float = 0.0


@dataclass
class BandNoiseEnergyStats:
    """Telemetry accumulated since the last read
    (``band_noise_streaming.py:81-119``)."""

    noise_energy_sum: float = 0.0
    rain_energy_sum: float = 0.0
    total_energy_sum: float = 0.0
    noise_frame_count: int = 0
    rain_frame_count: int = 0
    total_frame_count: int = 0
    noise_buffer_valid_count: int = 0
    noise_buffer_min_valid_count: int = 0
    noise_buffer_underflow_frame_count: int = 0
    frames_since_noise_update: int = 0
    noise_learned_subframe_count: int = 0
    noise_replenish_count: int = 0
    noise_effective_q: float = 0.0

    @property
    def noise_energy_mean(self) -> float:
        return self.noise_energy_sum / max(1, self.noise_frame_count)

    @property
    def rain_energy_mean(self) -> float:
        return self.rain_energy_sum / max(1, self.rain_frame_count)

    @property
    def total_energy_mean(self) -> float:
        return self.total_energy_sum / max(1, self.total_frame_count)

    def as_dict(self) -> Dict[str, Any]:
        d = {f.name: getattr(self, f.name) for f in fields(self)}
        d.update(
            noise_energy_mean=self.noise_energy_mean,
            rain_energy_mean=self.rain_energy_mean,
            total_energy_mean=self.total_energy_mean,
        )
        return d


_ARRAY_FIELDS = ("N_sub", "subE", "rain_submask")
_INT_FIELDS = {f.name for f in fields(BandNoiseFrameOut) if f.type in (int, "int")}


class BandNoiseEstimator:
    """Stateful per-frame wrapper over the estimator, on one device (the
    card unless the caller asks for the CPU).  ``process_frame(frame)``
    takes exactly ``cfg.frame_len`` samples and returns a
    :class:`BandNoiseFrameOut`; the carried state is the chunked path's, so
    frames streamed here give the bits of one whole-clip call."""

    def __init__(self, cfg: BandNoiseEstimatorConfig, device: str | torch.device = "cuda"):
        cfg.validate()
        self.cfg = cfg
        self.device = torch.device(device)
        self.state = band_noise_init_state(cfg, 1, self.device)
        self._stats_baseline: Dict[str, float] = {k: 0 for k in _ACCUM_FIELDS}
        self._last_out: Optional[Dict[str, np.ndarray]] = None

    def process_frame(self, frame) -> BandNoiseFrameOut:
        frame = torch.as_tensor(np.asarray(frame, np.float32).reshape(-1))
        if frame.shape[0] != self.cfg.frame_len:
            raise ValueError(
                f"process_frame expects exactly frame_len={self.cfg.frame_len} samples, "
                f"got {frame.shape[0]}")
        outs, self.state = band_noise_process_chunk(frame[None].to(self.device), self.cfg,
                                                    self.state)
        row = {k: v[0, 0].cpu().numpy() for k, v in outs.items()}
        self._last_out = row
        kw: Dict[str, Any] = {}
        for f in fields(BandNoiseFrameOut):
            v = row[f.name]
            if f.name in _ARRAY_FIELDS:
                kw[f.name] = np.asarray(v)
            elif f.name in _INT_FIELDS:
                kw[f.name] = int(v)
            elif f.name == "fft_rain_frame":
                kw[f.name] = bool(v)
            else:
                kw[f.name] = float(v)
        return BandNoiseFrameOut(**kw)

    def process_stream(self, x):
        """Cut a stream into frames and yield each frame's output."""
        x = np.asarray(x, np.float32).reshape(-1)
        N = self.cfg.frame_len
        for t in range(x.shape[0] // N):
            yield self.process_frame(x[t * N : (t + 1) * N])

    def reset_noise_estimator(self) -> None:
        """Clear the noise ring buffer and trackers, keep the filter state and
        the telemetry (``band_noise_streaming.py:170-173``)."""
        self.state = band_noise_reset_noise_estimator(self.cfg, self.state)

    def read_and_reset_energy_stats(self) -> BandNoiseEnergyStats:
        """The telemetry since the last read, then a new window."""
        if self._last_out is None:
            return BandNoiseEnergyStats()
        row = self._last_out
        kw: Dict[str, Any] = {}
        for k in _ACCUM_FIELDS:
            delta = row[k] - self._stats_baseline[k]
            kw[k] = int(delta) if "count" in k else float(delta)
            self._stats_baseline[k] = row[k]
        for k in _GAUGE_FIELDS:
            kw[k] = float(row[k]) if k == "noise_effective_q" else int(row[k])
        return BandNoiseEnergyStats(**kw)


class NoiseFrameDetector:
    """Standalone NumPy twin of the scan's frame detector
    (``band_noise_streaming.py:190-304``):

      * FFT: a rain-band power jump >= M_db AND a primary-band jump >= N_db
        marks the whole frame rain;
      * time domain: a subframe band dB-rise >= band_rise_db with an excess
        of >= excess_rise_db over the wideband rise, held for
        ``k_subframes`` subframes.
    """

    def __init__(self, cfg: NoiseFrameDetectorConfig, *, subframes_per_frame: int):
        self.cfg = cfg
        self.S = int(subframes_per_frame)
        self._rain_bins = [
            (hz_to_bin(lo, cfg.fs, cfg.n_fft), hz_to_bin(hi, cfg.fs, cfg.n_fft))
            for lo, hi in cfg.rain_bands_hz
        ]
        self._primary = (
            hz_to_bin(cfg.primary_hz[0], cfg.fs, cfg.n_fft),
            hz_to_bin(cfg.primary_hz[1], cfg.fs, cfg.n_fft),
        )
        self.reset()

    def reset(self) -> None:
        self._prev_rain_sum: Optional[float] = None
        self._prev_primary: Optional[float] = None
        self._prev_Lb: float = 0.0
        self._prev_Lh: float = 0.0
        self._have_prev_L = False
        self._prev_Eb: float = 0.0
        self._have_prev_Eb = False
        self._hold = 0

    @staticmethod
    def _band_sum(P: np.ndarray, b0: int, b1: int) -> float:
        b0 = int(np.clip(b0, 0, len(P) - 1))
        b1 = int(np.clip(b1, 0, len(P) - 1))
        return float(P[b0 : b1 + 1].sum()) if b1 >= b0 else 0.0

    def fft_rain_from_power(self, P: np.ndarray) -> bool:
        P = np.asarray(P).reshape(-1)
        rain_sum = sum(self._band_sum(P, b0, b1) for b0, b1 in self._rain_bins)
        primary = self._band_sum(P, *self._primary)
        if self._prev_rain_sum is None:
            self._prev_rain_sum, self._prev_primary = rain_sum, primary
            return False
        jump = rain_sum > (self._prev_rain_sum + _EPS) * db_to_ratio(self.cfg.M_db)
        pjump = primary > (self._prev_primary + _EPS) * db_to_ratio(self.cfg.N_db)
        self._prev_rain_sum, self._prev_primary = rain_sum, primary
        return bool(jump and pjump)

    def fft_rain(self, x: np.ndarray) -> bool:
        X = np.fft.rfft(np.asarray(x, np.float64), n=self.cfg.n_fft)
        return self.fft_rain_from_power(X.real**2 + X.imag**2)

    def time_rain_mask_from_subE(self, subE: np.ndarray,
                                 subEhpf: Optional[np.ndarray] = None) -> np.ndarray:
        det = self.cfg
        subE = np.asarray(subE, np.float64).reshape(-1)
        subEhpf = subE if subEhpf is None else np.asarray(subEhpf, np.float64).reshape(-1)
        mask = np.zeros(self.S, bool)
        for s in range(self.S):
            Eb_s = max(float(subE[s]), _EPS)
            m = self._hold > 0
            if m:
                self._hold -= 1

            Eh_s = float(subEhpf[s])
            energies_ok = (Eh_s >= det.min_Ehpf) and (Eb_s >= det.min_Eband)
            Lb = 10.0 * np.log10(Eb_s + _EPS)
            Lh = 10.0 * np.log10(Eh_s + _EPS)
            dLb = Lb - self._prev_Lb
            dLh = Lh - self._prev_Lh
            triggered = (
                energies_ok and self._have_prev_L
                and dLb >= det.band_rise_db
                and (dLb - dLh) >= det.excess_rise_db
            )
            if energies_ok:
                self._prev_Lb, self._prev_Lh = Lb, Lh
            self._have_prev_L = energies_ok

            if det.use_dE_over_Ehpf and not triggered:
                metric = max(Eb_s - self._prev_Eb, 0.0) / (max(Eh_s, _EPS) + _EPS)
                triggered = self._have_prev_Eb and metric >= det.dE_over_Ehpf_thr
            if det.use_D_trigger and not triggered:
                triggered = self._have_prev_Eb and (
                    Eb_s > (self._prev_Eb + _EPS) * db_to_ratio(det.D_db)
                )

            if triggered:
                self._hold = max(self._hold, max(0, int(det.k_subframes) - 1))
            self._prev_Eb = Eb_s
            self._have_prev_Eb = True
            mask[s] = m or triggered
        return mask

    def process_frame(self, x: np.ndarray, subE: np.ndarray, *,
                      subEhpf: Optional[np.ndarray] = None,
                      fft_power: Optional[np.ndarray] = None) -> Tuple[bool, np.ndarray]:
        """Returns ``(fft_rain_frame, rain_submask)``."""
        fft_rain_frame = (
            self.fft_rain_from_power(fft_power) if fft_power is not None
            else self.fft_rain(x)
        )
        time_mask = self.time_rain_mask_from_subE(subE, subEhpf=subEhpf)
        if fft_rain_frame:
            return True, np.ones(self.S, bool)
        return False, time_mask
