"""The reference of ``model="spectral"``: the spectral-noise rain detector's
per-clip outputs, plain PyTorch.

Frozen copy of the port's ``models/spectral_noise.py`` (the engine's
``_run`` in the default configuration) and ``models/frame_classifier.py``
on the CPU: the TD prefilter ``sosfiltfilt``, the power spectrogram, the
detector's noise PSD and its normalized-dB input, the frame classifier
(per-mode spectral flux over a causal low-quantile baseline, the TD crest
gate, the fixed-band decision), then the suppressor's noise PSD with the
non-noise frames excluded and the mean noise floor.  Only what the step's
per-clip outputs read is computed; a setting whose other branches the
port has and this copy leaves out raises.  ``store`` is applied to each
stage's output tensor: the identity for the reference, a round trip
through a narrower type for the benchmark's control.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as tnf

from ..config import NoiseConfig, build_noise_config
from ..consts import f32_recip, host
from ..filters import design_highpass, sosfiltfilt
from ..framing import frame_signal
from ..stats import crest_factor, nan_to_num
from ..stft import fft_frequencies, stft_power
from ..trackers import causal_low_quantile_baseline, make_psd_params, noise_psd_track

#: frame classes (``frame_classifier.py:49-54``)
NOISE, UNCERTAIN, RAIN = 0, 1, 2

#: ``NoiseConfig`` settings at the values this copy implements: the
#: engine's default configuration without audio, spectra, debug or dumps
_IMPLEMENTED = {
    "pre_filter_mode": "highpass", "adaptive_q_enable": False, "median_frames": 0,
    "pre_smooth_frames": 0, "detector_use_noise_norm": True,
    "detector_noise_norm_mode": "log_sub", "suppressor_bypass": False,
    "classifier_only_mode": False, "debug_enable": False, "dump_features": False,
    "compute_output_audio": False, "return_filtered_audio": False, "return_debug": False,
    "return_detector_debug": False, "return_spectra": False, "return_noise_psd": False,
}
#: detector settings (``cfg.dget``) at the values this copy implements
_DETECTOR_IMPLEMENTED = {
    "bypass_classifier": False, "td_apply_input_prefilter": True, "td_input_mode": "default",
    "td_soft_enable": False, "flux_modes_winsor_enable": False,
    "td_kurtosis_upper_threshold": None, "mode_weights": None, "mode_flux_norm_enable": True,
}


def _keep(t: torch.Tensor) -> torch.Tensor:
    return t


def _check_implemented(cfg: NoiseConfig) -> None:
    off = {k: getattr(cfg, k) for k, v in _IMPLEMENTED.items() if getattr(cfg, k) != v}
    off.update({k: cfg.dget(k, v) for k, v in _DETECTOR_IMPLEMENTED.items()
                if cfg.dget(k, v) != v})
    mode = str(cfg.dget("td_prefilter_mode", cfg.dget("pre_filter_mode", "none"))).lower()
    if mode != "highpass" or not cfg.hp_cutoff_hz > 0:
        off["td_prefilter_mode"] = mode
    if off:
        raise NotImplementedError(f"the spectral reference does not implement {off}")


def per_clip(params: Dict[str, Any], x: torch.Tensor,
             store: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
             ) -> Dict[str, torch.Tensor]:
    """The step's per-clip outputs of ``model="spectral"`` for the clips
    ``x`` (B, N): every frame's class, the rain frame count, the rain
    fraction, whether the clip rains (``clip_rain_min_frames`` rain frames
    or more) and the mean noise floor in dB."""
    sr = int(params.get("sample_rate", params.get("fs", 11162)))
    cfg = build_noise_config(sr, params)
    if cfg.fs != sr:
        raise NotImplementedError(f"fs {cfg.fs} differs from the sample rate {sr}")
    _check_implemented(cfg)
    frame_class, mean_noise_floor_db = _run(cfg, x.to(torch.float32), store or _keep)
    count = (frame_class == RAIN).sum(-1, dtype=torch.int32)
    cmin = max(1, int(params.get("clip_rain_min_frames", 1)))
    return {"frame_class": frame_class, "rain_frame_count": count,
            "clip_rain_fraction": (count.to(torch.float32)
                                   * f32_recip(frame_class.shape[-1], x.device)),
            "clip_is_rain": count >= cmin, "mean_noise_floor_db": mean_noise_floor_db}


class BandGeometry:
    """Host constants of the detector: operating-band rows and mode masks
    (``frame_classifier.py:219-259``)."""

    def __init__(self, cfg: NoiseConfig):
        self.fs = int(cfg.dget("sample_rate", cfg.dget("fs", 11162)))
        self.n_fft = int(cfg.dget("n_fft", 256))
        self.hop = int(cfg.dget("hop", 128))
        op_band = cfg.dget("operating_band", (400.0, 3500.0))
        self.op_band = (float(op_band[0]), float(op_band[1]))
        self.mode_bands = tuple((float(a), float(b)) for (a, b) in cfg.dget("mode_bands", None))
        freqs = fft_frequencies(self.fs, self.n_fft)
        band_mask = (freqs >= self.op_band[0]) & (freqs <= self.op_band[1])
        self.band_rows = np.flatnonzero(band_mask)
        freqs_band = freqs[band_mask]
        self.mode_masks = np.stack(
            [(freqs_band >= lo) & (freqs_band <= hi) for lo, hi in self.mode_bands])


def _run(cfg: NoiseConfig, x: torch.Tensor, store) -> tuple:
    """The engine on a float32 ``(B, N)`` batch (``spectral_noise.py:200-429``):
    ``(frame_class, mean_noise_floor_db)``."""
    x = store(x)
    geo = BandGeometry(cfg)
    x_td = store(sosfiltfilt(design_highpass(geo.fs, cfg.hp_cutoff_hz, cfg.hp_order), x))
    P = store(stft_power(x, n_fft=cfg.n_fft, hop=cfg.hop))
    # the operating band is one run of rows, so this is a view
    rows = slice(int(geo.band_rows[0]), int(geo.band_rows[-1]) + 1)
    P_band = P[:, rows, :]
    B, _, T = P_band.shape

    # the detector's input: the noise PSD tracked with no rain exclusion,
    # lagged one frame and clamped to maxr * P, in dB (``:285-302``)
    N_det = _noise_psd_band(cfg, P_band, torch.zeros((B, T), dtype=torch.bool), store)
    lag = torch.roll(N_det, 1, dims=-1)
    lag[..., 0] = N_det[..., 0]
    lag = torch.minimum(lag, _max_ratio(cfg) * P_band)
    P_det = store(10.0 * torch.log10(P_band + cfg.eps) - 10.0 * torch.log10(lag + cfg.eps))
    frame_class = _classify(cfg, geo, P_det, x_td)

    # the suppressor's noise PSD over the noise frames (``:346-429``)
    N_band = _noise_psd_band(cfg, P_band, frame_class != NOISE, store)
    noise_db = 10.0 * torch.log10(N_band + cfg.eps)
    return frame_class, torch.mean(noise_db, dim=(-2, -1))


def _max_ratio(cfg: NoiseConfig) -> float:
    """``noise_psd_max_ratio`` clipped to [0, 1], 1 when not finite."""
    maxr = float(cfg.noise_psd_max_ratio)
    return 1.0 if not np.isfinite(maxr) else float(np.clip(maxr, 0.0, 1.0))


def _noise_psd_band(cfg: NoiseConfig, P_band: torch.Tensor, is_rain: torch.Tensor,
                    store) -> torch.Tensor:
    """The noise PSD on the band rows (``spectral_noise.py:250-263``): the
    tracker (the plain loop of K2) with ``is_rain`` frames excluded."""
    params = make_psd_params(
        cfg_q=cfg.q, win_sec=cfg.win_sec, frames_per_sec=float(cfg.fs) / float(cfg.hop),
        ema_up=cfg.ema_up, ema_down=cfg.ema_down, eps=cfg.eps,
        noise_psd_max_ratio=cfg.noise_psd_max_ratio)
    return store(noise_psd_track(P_band, is_rain, params))


def _classify(cfg: NoiseConfig, geo: BandGeometry, P_band: torch.Tensor,
              x_td: torch.Tensor) -> torch.Tensor:
    """The frame classifier (``frame_classifier.py:211-606``) on the
    operating-band rows ``P_band`` (B, K, T) of the detector input and the
    TD-prefiltered waveform ``x_td``: each frame's class, int8 (B, T)."""
    eps = float(cfg.dget("eps", 1e-9))
    T = P_band.shape[-1]

    # the TD crest factor of each frame, zero-filled to T frames
    frames = frame_signal(x_td.to(torch.float32), geo.n_fft, geo.hop)
    crest = crest_factor(frames, dim=-1, eps=eps)
    td_crest = nan_to_num(tnf.pad(crest, (0, T - crest.shape[-1])))

    # t vs t-2 positive rise flux per mode band, frames 0 and 1 zero; the
    # band sums are float32 matrix products with 0/1 masks
    flux = torch.zeros_like(P_band)
    flux[..., 2:] = torch.clamp(P_band[..., 2:] - P_band[..., :-2], min=0.0)
    mode_flux_by_mode = torch.matmul(host(lambda: geo.mode_masks), flux)
    flux_modes = torch.sum(mode_flux_by_mode, dim=-2)

    norm_win_sec = float(cfg.dget("mode_flux_norm_win_sec", 0.5))
    norm_q = float(np.clip(float(cfg.dget("mode_flux_norm_q", 20.0)), 0.0, 100.0))
    norm_min = max(float(cfg.dget("mode_flux_norm_min", 1.0)), eps)
    frames_per_sec = float(geo.fs) / max(float(geo.hop), 1.0)

    # one stacked tracker for all 1 + n_modes baselines (the plain loop of K3)
    stacked = torch.cat([flux_modes[..., None, :], mode_flux_by_mode], dim=-2)
    base_stacked = causal_low_quantile_baseline(
        stacked, q_percent=norm_q, samples_per_sec=frames_per_sec,
        win_sec=norm_win_sec, floor=norm_min)
    base_all = base_stacked[..., 0, :]
    base_modes = base_stacked[..., 1:, :]

    excess_all = torch.clamp(flux_modes - base_all, min=0.0)
    mode_flux_score = nan_to_num(excess_all / (base_all + norm_min))
    excess_modes = torch.clamp(mode_flux_by_mode - base_modes, min=0.0)
    normalized_mode_flux = nan_to_num(excess_modes / (base_modes + norm_min))

    # the fixed-band log1p decision under the crest gate (``:173-191``)
    legacy12 = float(cfg.dget("new_rain_mode12_flux_min", 2.6))
    gate = (td_crest > float(cfg.dget("td_gate_threshold", 2.5))).to(torch.float32)
    f = [torch.log1p(torch.clamp(nan_to_num(normalized_mode_flux[..., i, :]) * gate, min=0.0))
         for i in range(4)]
    primary_ok = f[0] >= float(cfg.dget("new_rain_primary_flux_min", 1.8))
    hits = (
        (f[1] >= float(cfg.dget("new_rain_mode1_flux_min", legacy12))).to(torch.int32)
        + (f[2] >= float(cfg.dget("new_rain_mode2_flux_min", legacy12))).to(torch.int32)
        + (f[3] >= float(cfg.dget("new_rain_mode3_flux_min", 3.0))).to(torch.int32)
    )
    is_rain = primary_ok & (hits >= max(1, int(cfg.dget("new_rain_min_support_count", 2))))

    noise_conf = torch.clamp(1.0 - is_rain.to(torch.float32), 0.0, 1.0)
    weak = mode_flux_score * gate <= max(float(cfg.dget("mode_flux_noise_max", 1.5)), 0.0)
    return torch.where(
        is_rain, RAIN,
        torch.where((noise_conf >= float(cfg.dget("noise_hi", 0.80))) & weak, NOISE,
                    UNCERTAIN)).to(torch.int8)
