"""Rain / noise frame classifier, batched over clips.

Counterpart of ``audio_processing_tools_tpu/models/frame_classifier.py``:
``FrameClass`` (``:49-54``), ``build_prefilter_sos`` (``:57-65``),
``_align_to_frames`` (``:68-75``), ``_mode_flux`` (``:78-103``),
``rain_frame_decision`` (``:173-191``), ``assign_td_soft_label``
(``:194-208``) and ``detect_rain_over_time`` (``:211-606``) without the peak
gate:

  * t-vs-(t-2) positive spectral flux per mode band,
  * the causal low-quantile normalization of the combined and per-mode flux
    as one stacked (1 + n_modes)-row tracker (kernel K3 on the card),
  * the time-domain crest gate and the fixed-band log1p decision.

Eager PyTorch computes whatever it is given, so the work that XLA dropped
as dead code is skipped here by design: the block-energy and raw spectral
features are computed only for the debug outputs or feature dump that carry
them, and kurtosis only when ``td_kurtosis_upper_threshold`` reads it.
Configurations outside the ported slice raise ``NotImplementedError``
naming their ROADMAP item.
"""

from __future__ import annotations

from enum import IntEnum
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as tnf

from audio_processing_tools_tpu_torch.config import NoiseConfig
from audio_processing_tools_tpu_torch.ops._device import device_constant
from audio_processing_tools_tpu_torch.ops.features_spec import (
    RAW_SPECTRAL_FEATURE_NAMES,
    extract_raw_spectral_features,
)
from audio_processing_tools_tpu_torch.ops.features_td import extract_td_features
from audio_processing_tools_tpu_torch.ops.filters import (
    design_bandpass,
    design_highpass,
    sosfiltfilt,
)
from audio_processing_tools_tpu_torch.ops.stats import nan_to_num, quantile_linear
from audio_processing_tools_tpu_torch.ops.stft import fft_frequencies
from audio_processing_tools_tpu_torch.ops.trackers import causal_low_quantile_baseline


class FrameClass(IntEnum):
    """Frame classes."""

    NOISE = 0
    UNCERTAIN = 1
    RAIN = 2


def build_prefilter_sos(cfg: NoiseConfig, sr: int, mode: str) -> Optional[np.ndarray]:
    """Engine pre-filter design (``frame_classifier.py:57-65``)."""
    if mode == "bandpass":
        op_lo, op_hi = cfg.operating_band
        return design_bandpass(sr, float(op_lo), float(op_hi),
                               int(getattr(cfg, "bp_order", cfg.hp_order)))
    if mode == "highpass" and cfg.hp_cutoff_hz > 0:
        return design_highpass(sr, cfg.hp_cutoff_hz, cfg.hp_order)
    return None


def td_prefilter_sos(cfg: NoiseConfig) -> Optional[np.ndarray]:
    """The detector's TD prefilter design, or None when it is off
    (``frame_classifier.py:262-270``)."""
    fs = int(cfg.dget("sample_rate", cfg.dget("fs", 11162)))
    mode = str(cfg.dget("td_prefilter_mode", cfg.dget("pre_filter_mode", "none"))).lower()
    if not cfg.dflag("td_apply_input_prefilter", True) or mode in ("", "none"):
        return None
    return build_prefilter_sos(cfg, fs, mode)


def check_detector_slice(cfg: NoiseConfig) -> None:
    """Raise ``NotImplementedError`` for detector options not ported yet."""
    todo = {
        "peak_features_enable": "the peak-structure gate (ROADMAP P9)",
        "td_envelope_features_enable": "TD envelope-shape features (ROADMAP P9)",
        "clip_spectral_occupancy_enable": "clip spectral occupancy (ROADMAP P9)",
    }
    for flag, what in todo.items():
        if cfg.dflag(flag, False):
            raise NotImplementedError(f"{flag}: {what} is not ported yet")
    mode = str(cfg.dget("td_input_mode", "default")).lower()
    if mode != "default":
        raise NotImplementedError(
            f"td_input_mode={mode!r}: only the default TD front end is ported (ROADMAP P9)")
    if (cfg.dump_features and int(cfg.dget("feature_dump_level", 0)) > 0
            and cfg.dflag("feature_dump_sparse_enable", False)):
        raise NotImplementedError(
            "feature_dump_sparse_enable: the sparse feature-dump tier is not ported yet (ROADMAP P9)")


def _align_to_frames(arr: torch.Tensor, T: int) -> torch.Tensor:
    """Truncate / zero-fill a per-frame feature to T frames."""
    n = arr.shape[-1]
    if n >= T:
        return arr[..., :T]
    return tnf.pad(arr, (0, T - n))


def _mode_flux(P_band: torch.Tensor, mode_masks: np.ndarray,
               primary_mask: np.ndarray, mode_weights):
    """t vs t-2 positive rise flux per mode band; frames 0 and 1 carry zero
    flux.  ``P_band`` (..., K, T).  The band reductions are float32 matrix
    products with 0/1 masks."""
    T = P_band.shape[-1]
    flux = torch.zeros_like(P_band)
    if T > 2:
        flux[..., 2:] = torch.clamp(P_band[..., 2:] - P_band[..., :-2], min=0.0)
    sel, prim = device_constant(
        ("mode_masks", mode_masks.tobytes(), mode_masks.shape, primary_mask.tobytes()),
        P_band.device, lambda: (mode_masks, primary_mask[None, :]))
    mode_flux_by_mode = torch.matmul(sel, flux)                              # (..., n_modes, T)
    flux_primary = torch.matmul(prim, flux)[..., 0, :]
    if mode_weights is not None:
        w = device_constant(("mode_weights", tuple(mode_weights)), P_band.device,
                            lambda: np.asarray(mode_weights))
        flux_modes = torch.sum(w[:, None] * mode_flux_by_mode, dim=-2)
    else:
        flux_modes = torch.sum(mode_flux_by_mode, dim=-2)
    return flux, flux_primary, flux_modes, mode_flux_by_mode


def rain_frame_decision(primary, s1, s2, s3, *, primary_flux_min: float,
                        mode1_flux_min: float, mode2_flux_min: float,
                        mode3_flux_min: float, min_support_count: int):
    """Fixed-band log1p decision (``frame_classifier.py:173-191``)."""
    f0 = torch.log1p(torch.clamp(primary, min=0.0))
    f1 = torch.log1p(torch.clamp(s1, min=0.0))
    f2 = torch.log1p(torch.clamp(s2, min=0.0))
    f3 = torch.log1p(torch.clamp(s3, min=0.0))
    msc = max(1, int(min_support_count))
    primary_ok = f0 >= float(primary_flux_min)
    hits = (
        (f1 >= float(mode1_flux_min)).to(torch.int32)
        + (f2 >= float(mode2_flux_min)).to(torch.int32)
        + (f3 >= float(mode3_flux_min)).to(torch.int32)
    )
    is_rain = primary_ok & (hits >= msc)
    return is_rain, is_rain.to(torch.float32)


def assign_td_soft_label(*, td_crest_factor, td_kurtosis, crest_thr: float,
                         kurt_thr: float, min_positive_votes: int = 2
                         ) -> Dict[str, torch.Tensor]:
    """TD soft label from crest/kurtosis voting (``:194-208``)."""
    votes = (td_crest_factor >= float(crest_thr)).to(torch.int32) + (
        td_kurtosis >= float(kurt_thr)).to(torch.int32)
    return {
        "td_vote_count": votes,
        "td_soft_score": votes.to(torch.float32) / 2.0,
        "td_soft_label": votes >= int(min_positive_votes),
    }


class BandGeometry:
    """Host constants of the detector: operating-band rows and mode masks
    (``frame_classifier.py:219-259``)."""

    def __init__(self, cfg: NoiseConfig):
        self.fs = int(cfg.dget("sample_rate", cfg.dget("fs", 11162)))
        self.n_fft = int(cfg.dget("n_fft", 256))
        self.hop = int(cfg.dget("hop", 128))
        op_band = cfg.dget("operating_band", (400.0, 3500.0))
        self.op_band = (float(op_band[0]), float(op_band[1]))
        mode_bands = cfg.dget("mode_bands", None)
        if mode_bands is None:
            raise AttributeError("Missing required detector param: mode_bands")
        self.mode_bands = tuple((float(a), float(b)) for (a, b) in mode_bands)
        if len(self.mode_bands) < 4:
            raise ValueError("Fixed-band rain decision requires at least 4 mode bands")
        mw = cfg.dget("mode_weights", None)
        self.mode_weights = None if mw is None else tuple(float(w) for w in mw)
        if self.mode_weights is not None and len(self.mode_weights) != len(self.mode_bands):
            raise ValueError("mode_weights length must match mode_bands length")

        freqs = fft_frequencies(self.fs, self.n_fft)
        band_mask = (freqs >= self.op_band[0]) & (freqs <= self.op_band[1])
        if not band_mask.any():
            raise ValueError("operating_band does not overlap the frequency grid")
        self.band_rows = np.flatnonzero(band_mask)
        freqs_band = freqs[band_mask]
        p_lo, p_hi = self.mode_bands[0]
        self.primary_mask = (freqs_band >= p_lo) & (freqs_band <= p_hi)
        if not self.primary_mask.any():
            raise ValueError("primary mode band has no bins inside operating_band")
        self.mode_masks = np.stack(
            [(freqs_band >= lo) & (freqs_band <= hi) for lo, hi in self.mode_bands])


def detect_rain_over_time(
    cfg: NoiseConfig,
    P_det: torch.Tensor,
    x: torch.Tensor,
    raw_power: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, Any], Dict[str, Any]]:
    """Classifier over ``P_det`` (..., F, T) normalized-dB detector input and
    the raw waveform ``x`` (..., n).  Returns ``(frame_class, rain_conf,
    det_debug, feature_dump)`` with the full ``det_debug``."""
    geo = BandGeometry(cfg)
    sos = td_prefilter_sos(cfg)
    x_td = sosfiltfilt(sos, x) if sos is not None else x
    return detect_from_band(cfg, geo, P_det[..., geo.band_rows, :], x_td,
                            raw_power, debug=True)


def detect_from_band(
    cfg: NoiseConfig,
    geo: BandGeometry,
    P_band: torch.Tensor,
    x_td: torch.Tensor,
    raw_power: Optional[torch.Tensor],
    *,
    debug: bool,
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, Any], Dict[str, Any]]:
    """The classifier body on the operating-band rows ``P_band`` (..., K, T)
    of the detector input and the TD-prefiltered waveform ``x_td``.
    ``debug=False`` leaves out of ``det_debug`` everything but
    ``noise_conf``, and skips the features only the debug output reads."""
    check_detector_slice(cfg)
    eps = float(cfg.dget("eps", 1e-9))
    T = P_band.shape[-1]
    dev = P_band.device
    lead = P_band.shape[:-2]

    dump = cfg.dump_features and int(cfg.dget("feature_dump_level", 0)) > 0
    dense = dump and cfg.dflag("feature_dump_dense_enable", True)
    dump_td_soft = dense and cfg.dflag("feature_dump_include_td_soft", False)
    td_kurt_upper = cfg.dget("td_kurtosis_upper_threshold", None)
    td_soft_enable = cfg.dflag("td_soft_enable", False)

    # ---------------- TD features: only what a consumer reads ----------------
    td_names = {"td_crest_factor"}
    if debug or dump_td_soft or td_soft_enable or td_kurt_upper is not None:
        td_names.add("td_kurtosis")
    if debug or dense:
        td_names.update(("td_block_energy_crest", "td_block_peak_width_50",
                         "td_block_post_pre_energy_ratio"))
    hop_blk = cfg.dget("td_block_energy_hop", None)
    td = extract_td_features(
        x_td, fs=geo.fs, frame_len=geo.n_fft, hop=geo.hop,
        td_input_mode=str(cfg.dget("td_input_mode", "default")),
        block_energy_len=int(cfg.dget("td_block_energy_len", 8)),
        block_energy_hop=None if hop_blk is None else int(hop_blk),
        block_energy_post_pre_blocks=int(cfg.dget("td_block_energy_post_pre_blocks", 4)),
        block_energy_smooth_enable=cfg.dflag("td_block_energy_smooth_enable", True),
        eps=eps, names=td_names,
    )
    aligned_td = {k: nan_to_num(_align_to_frames(v, T)) for k, v in td.items()
                  if k != "frame_times"}
    td_crest = aligned_td["td_crest_factor"]
    td_kurt = aligned_td.get("td_kurtosis")

    zeros_f = P_band.new_zeros(lead + (T,))
    if td_soft_enable:
        soft = assign_td_soft_label(
            td_crest_factor=td_crest, td_kurtosis=td_kurt,
            crest_thr=float(cfg.dget("td_soft_crest_factor_min", 4.0)),
            kurt_thr=float(cfg.dget("td_soft_kurtosis_min", 6.0)),
            min_positive_votes=int(cfg.dget("td_soft_min_positive_votes", 2)),
        )
    else:
        soft = {
            "td_vote_count": torch.zeros(lead + (T,), dtype=torch.int32, device=dev),
            "td_soft_score": zeros_f,
            "td_soft_label": torch.zeros(lead + (T,), dtype=torch.bool, device=dev),
        }

    # ---------------- spectral flux ----------------
    flux, flux_primary, flux_modes, mode_flux_by_mode = _mode_flux(
        P_band, geo.mode_masks, geo.primary_mask, geo.mode_weights)

    flux_modes_proc = flux_modes
    if cfg.dflag("flux_modes_winsor_enable", False):
        wq = float(np.clip(float(cfg.dget("flux_modes_winsor_q", 99.0)), 50.0, 100.0))
        winsor_hi = quantile_linear(flux_modes_proc, wq / 100.0)
        flux_modes_proc = torch.minimum(flux_modes_proc, winsor_hi[..., None])

    norm_enable = cfg.dflag("mode_flux_norm_enable", True)
    norm_win_sec = float(cfg.dget("mode_flux_norm_win_sec", 0.5))
    norm_q = float(np.clip(float(cfg.dget("mode_flux_norm_q", 20.0)), 0.0, 100.0))
    norm_min = max(float(cfg.dget("mode_flux_norm_min", 1.0)), eps)
    frames_per_sec = float(geo.fs) / max(float(geo.hop), 1.0)

    # one stacked tracker for all 1 + n_modes baselines
    stacked = torch.cat([flux_modes_proc[..., None, :], mode_flux_by_mode], dim=-2)
    base_stacked, _ = causal_low_quantile_baseline(
        stacked, q_percent=norm_q, samples_per_sec=frames_per_sec,
        win_sec=norm_win_sec, min_hist_sec=0.0, floor=norm_min,
    )
    base_all = base_stacked[..., 0, :]
    base_modes = base_stacked[..., 1:, :]

    excess_all = torch.clamp(flux_modes_proc - base_all, min=0.0)
    mode_flux_score = excess_all / (base_all + norm_min) if norm_enable else excess_all
    excess_modes = torch.clamp(mode_flux_by_mode - base_modes, min=0.0)
    normalized_mode_flux = nan_to_num(
        excess_modes / (base_modes + norm_min) if norm_enable else excess_modes)

    # ---------------- decision ----------------
    mode_flux_score = nan_to_num(mode_flux_score)
    legacy12 = float(cfg.dget("new_rain_mode12_flux_min", 2.6))
    primary_flux = nan_to_num(normalized_mode_flux[..., 0, :])
    s1 = nan_to_num(normalized_mode_flux[..., 1, :])
    s2 = nan_to_num(normalized_mode_flux[..., 2, :])
    s3 = nan_to_num(normalized_mode_flux[..., 3, :])

    td_gate_mask = td_crest > float(cfg.dget("td_gate_threshold", 2.5))
    if td_kurt_upper is not None:
        td_gate_mask = td_gate_mask & (td_kurt <= float(td_kurt_upper))
    gate = td_gate_mask.to(torch.float32)

    primary_g = primary_flux * gate
    s1_g, s2_g, s3_g = s1 * gate, s2 * gate, s3 * gate
    is_rain, rain_conf = rain_frame_decision(
        primary_g, s1_g, s2_g, s3_g,
        primary_flux_min=float(cfg.dget("new_rain_primary_flux_min", 1.8)),
        mode1_flux_min=float(cfg.dget("new_rain_mode1_flux_min", legacy12)),
        mode2_flux_min=float(cfg.dget("new_rain_mode2_flux_min", legacy12)),
        mode3_flux_min=float(cfg.dget("new_rain_mode3_flux_min", 3.0)),
        min_support_count=int(cfg.dget("new_rain_min_support_count", 2)),
    )

    noise_conf = torch.clamp(1.0 - rain_conf, 0.0, 1.0)
    mode_flux_noise_max = max(float(cfg.dget("mode_flux_noise_max", 1.5)), 0.0)
    noise_hi = float(cfg.dget("noise_hi", 0.80))
    score_gated = mode_flux_score * gate
    weak = score_gated <= mode_flux_noise_max

    frame_class = torch.where(
        is_rain, int(FrameClass.RAIN),
        torch.where((noise_conf >= noise_hi) & weak, int(FrameClass.NOISE),
                    int(FrameClass.UNCERTAIN))).to(torch.int8)

    s4 = (nan_to_num(normalized_mode_flux[..., 4, :])
          if normalized_mode_flux.shape[-2] > 4 else torch.zeros_like(primary_flux))
    det_debug: Dict[str, Any] = {"noise_conf": noise_conf, "peak_features_enable": False}
    if debug:
        det_debug.update({
            "mode_flux_score": mode_flux_score,
            "mode_flux_score_gated": score_gated,
            "primary_mode_flux": primary_flux,
            "support_mode_flux_1": s1,
            "support_mode_flux_2": s2,
            "support_mode_flux_3": s3,
            "support_mode_flux_4": s4,
            "primary_mode_flux_gated": primary_g,
            "support_mode_flux_1_gated": s1_g,
            "support_mode_flux_2_gated": s2_g,
            "support_mode_flux_3_gated": s3_g,
            "rain_conf": rain_conf,
            "frame_class": frame_class,
            "td_crest_factor": td_crest,
            "td_kurtosis": td_kurt,
            "td_block_energy_crest": aligned_td["td_block_energy_crest"],
            "td_block_peak_width_50": aligned_td["td_block_peak_width_50"],
            "td_block_post_pre_energy_ratio": aligned_td["td_block_post_pre_energy_ratio"],
            "td_gate_mask": td_gate_mask,
            **soft,
            "mode_flux_by_mode": mode_flux_by_mode,
            "normalized_mode_flux_by_mode": normalized_mode_flux,
            "flux_primary_raw": flux_primary,
            "flux_modes_raw": flux_modes,
        })
        raw = {name: zeros_f for name in RAW_SPECTRAL_FEATURE_NAMES}
        if cfg.dflag("raw_spectral_shape_enable", True) and raw_power is not None:
            rb = cfg.dget("raw_spectral_rain_band", (400.0, 800.0))
            lb = cfg.dget("raw_spectral_low_band", (50.0, 200.0))
            raw = extract_raw_spectral_features(
                raw_power, fs=geo.fs, n_fft=geo.n_fft, operating_band=geo.op_band,
                rain_band=(float(rb[0]), float(rb[1])),
                low_band=(float(lb[0]), float(lb[1])),
                mode_bands=geo.mode_bands,
                rolloff_fraction=float(cfg.dget("raw_spectral_rolloff_fraction", 0.85)),
                eps=eps,
            )
            raw = {k: _align_to_frames(v, T) for k, v in raw.items()}
        det_debug.update(raw)

    feature_dump: Dict[str, Any] = {}
    if dense:
        feature_dump.update({
            "primary_mode_flux": primary_flux,
            "support_mode_flux_1": s1,
            "support_mode_flux_2": s2,
            "support_mode_flux_3": s3,
            "support_mode_flux_4": s4,
            "td_block_energy_crest": aligned_td["td_block_energy_crest"],
            "td_block_peak_width_50": aligned_td["td_block_peak_width_50"],
            "td_block_post_pre_energy_ratio": aligned_td["td_block_post_pre_energy_ratio"],
            "td_gate_mask": td_gate_mask,
        })
        if cfg.dflag("feature_dump_include_frame_class", True):
            feature_dump["frame_class"] = frame_class
        if dump_td_soft:
            feature_dump.update({
                "td_crest_factor": td_crest,
                "td_kurtosis": td_kurt,
                "td_vote_count": soft["td_vote_count"],
                "td_soft_score": soft["td_soft_score"],
            })
    return frame_class, rain_conf, det_debug, feature_dump
