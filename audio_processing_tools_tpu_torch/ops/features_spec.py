"""Raw spectral-shape frame features and clip occupancy, batched over clips.

Counterpart of ``audio_processing_tools_tpu/ops/features_spec.py``:

  * ``extract_raw_spectral_features`` (``:85-214``): centroid, bandwidth,
    band ratios, mode-band entropy/std/max, flatness, rolloff, dominant
    frequency, frame energy and the real cepstrum 0..4 over the operating
    band, from a linear power spectrogram ``(..., F, T)``; the cepstrum uses
    ``torch.fft.irfft``;
  * ``default_spectral_occupancy_bands`` and ``clip_spectral_occupancy``
    (``:217-317``): per-band log-power and power-ratio statistics of a clip,
    split by rain and no-rain frames.

Band masks are host constants.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from audio_processing_tools_tpu_torch.config import DEFAULT_MODE_BANDS
from audio_processing_tools_tpu_torch.ops._device import device_constant
from audio_processing_tools_tpu_torch.ops.stft import fft_frequencies

RAW_SPECTRAL_FEATURE_NAMES = (
    "raw_spectral_centroid_hz",
    "raw_spectral_bandwidth_hz",
    "raw_low_freq_ratio",
    "raw_rain_band_ratio",
    "raw_mode_band_ratio_0",
    "raw_mode_band_ratio_1",
    "raw_mode_band_ratio_2",
    "raw_mode_band_ratio_3",
    "raw_mode_band_ratio_4",
    "raw_mode_band_entropy",
    "raw_mode_band_std",
    "raw_mode_band_max_ratio",
    "raw_spectral_flatness",
    "raw_spectral_rolloff_hz",
    "raw_dominant_freq_hz",
    "raw_frame_energy",
    "raw_cepstrum_coeff_0",
    "raw_cepstrum_coeff_1",
    "raw_cepstrum_coeff_2",
    "raw_cepstrum_coeff_3",
    "raw_cepstrum_coeff_4",
)


def _band_sum(power: torch.Tensor, mask: np.ndarray) -> torch.Tensor:
    return torch.sum(power[..., np.flatnonzero(mask), :], dim=-2)


def extract_raw_spectral_features(
    power: torch.Tensor,
    *,
    fs: int,
    n_fft: int,
    operating_band: Tuple[float, float],
    rain_band: Tuple[float, float] = (400.0, 800.0),
    low_band: Tuple[float, float] = (0.0, 200.0),
    mode_bands: Optional[Tuple[Tuple[float, float], ...]] = None,
    rolloff_fraction: float = 0.85,
    eps: float = 1e-12,
) -> Dict[str, torch.Tensor]:
    """Spectral-shape features of ``power`` (..., F, T), each (..., T)."""
    freqs = fft_frequencies(fs, n_fft)
    power = power.to(torch.float32)
    dev = power.device
    zeros = power.new_zeros(power.shape[:-2] + power.shape[-1:])

    total = torch.sum(power, dim=-2) + eps
    non_dc = freqs > 0.0
    total_no_dc = _band_sum(power, non_dc) + eps if non_dc.any() else total

    low_lo, low_hi = float(low_band[0]), float(low_band[1])
    rain_lo, rain_hi = float(rain_band[0]), float(rain_band[1])
    op_lo, op_hi = float(operating_band[0]), float(operating_band[1])

    low_mask = (freqs >= max(low_lo, eps)) & (freqs < low_hi)
    rain_mask = (freqs >= rain_lo) & (freqs <= rain_hi)
    op_mask = (freqs >= op_lo) & (freqs <= op_hi)

    op_power = _band_sum(power, op_mask) + eps if op_mask.any() else total

    shape_sel = op_mask if op_mask.any() else non_dc
    shape_power = power[..., np.flatnonzero(shape_sel), :]
    shape_freqs = freqs[shape_sel]
    if shape_power.shape[-2] == 0:
        shape_power, shape_freqs = power, freqs

    shape_total = torch.sum(shape_power, dim=-2) + eps
    fcol = torch.as_tensor(shape_freqs.reshape(-1, 1), dtype=torch.float32, device=dev)

    centroid = torch.sum(fcol * shape_power, dim=-2) / shape_total
    bandwidth = torch.sqrt(
        torch.sum(((fcol - centroid[..., None, :]) ** 2) * shape_power, dim=-2) / shape_total
    )

    low_ratio = _band_sum(power, low_mask) / total_no_dc if low_mask.any() else zeros
    rain_ratio = _band_sum(power, rain_mask) / total_no_dc if rain_mask.any() else zeros

    mb = mode_bands if mode_bands is not None else DEFAULT_MODE_BANDS
    mode_powers = []
    for lo, hi in mb:
        m = (freqs >= float(lo)) & (freqs <= float(hi))
        mode_powers.append(_band_sum(power, m) if m.any() else zeros)
    mode_power = torch.stack(mode_powers, dim=-2)  # (..., n_modes, T)
    mode_total = torch.sum(mode_power, dim=-2) + eps
    mode_ratio = mode_power / mode_total[..., None, :]
    mode_entropy = -torch.sum(mode_ratio * torch.log(mode_ratio + eps), dim=-2)
    mode_std = torch.std(mode_ratio, dim=-2, correction=0)
    mode_max = torch.amax(mode_ratio, dim=-2)

    flat_power = shape_power if op_mask.any() else power
    flatness = torch.exp(torch.mean(torch.log(flat_power + eps), dim=-2)) / (
        torch.mean(flat_power + eps, dim=-2) + eps
    )

    cum = torch.cumsum(shape_power, dim=-2)
    thresh = float(np.clip(rolloff_fraction, 0.0, 1.0)) * shape_total
    # first bin whose cumulative power reaches the threshold (0 if none)
    roll_idx = torch.argmax((cum >= thresh[..., None, :]).to(torch.uint8), dim=-2)
    sf = torch.as_tensor(shape_freqs, dtype=torch.float32, device=dev)
    rolloff = sf[torch.clamp(roll_idx, 0, sf.shape[0] - 1)]
    dominant = sf[torch.argmax(shape_power, dim=-2)]

    cep_in = torch.log(torch.clamp(shape_power, min=eps))
    cepstrum = torch.fft.irfft(cep_in.transpose(-1, -2), dim=-1)  # (..., T, n_cep_full)
    n_cep = min(5, cepstrum.shape[-1])
    cep = [cepstrum[..., i] if i < n_cep else zeros for i in range(5)]

    def mode_or_zero(i):
        return mode_ratio[..., i, :] if mode_ratio.shape[-2] > i else zeros

    return {
        "raw_spectral_centroid_hz": centroid,
        "raw_spectral_bandwidth_hz": bandwidth,
        "raw_low_freq_ratio": low_ratio,
        "raw_rain_band_ratio": rain_ratio,
        "raw_mode_band_ratio_0": mode_or_zero(0),
        "raw_mode_band_ratio_1": mode_or_zero(1),
        "raw_mode_band_ratio_2": mode_or_zero(2),
        "raw_mode_band_ratio_3": mode_or_zero(3),
        "raw_mode_band_ratio_4": mode_or_zero(4),
        "raw_mode_band_entropy": mode_entropy,
        "raw_mode_band_std": mode_std,
        "raw_mode_band_max_ratio": mode_max,
        "raw_spectral_flatness": flatness,
        "raw_spectral_rolloff_hz": rolloff,
        "raw_dominant_freq_hz": dominant,
        "raw_frame_energy": op_power,
        "raw_cepstrum_coeff_0": cep[0],
        "raw_cepstrum_coeff_1": cep[1],
        "raw_cepstrum_coeff_2": cep[2],
        "raw_cepstrum_coeff_3": cep[3],
        "raw_cepstrum_coeff_4": cep[4],
    }


def default_spectral_occupancy_bands() -> Tuple[Tuple[str, float, float], ...]:
    """Semantic bands for clip occupancy (``features_spec.py:217-236``)."""
    return (
        ("dc", 0.0, 43.6015625),
        ("wind_1", 43.6015625, 261.609375),
        ("wind_2", 261.609375, 436.015625),
        ("mode_1", 436.015625, 654.0234375),
        ("inter_1", 654.0234375, 784.828125),
        ("mode_2", 784.828125, 1046.4375),
        ("inter_2a", 1046.4375, 1264.4453125),
        ("inter_2b", 1264.4453125, 1482.453125),
        ("mode_3", 1482.453125, 1787.6640625),
        ("inter_3a", 1787.6640625, 2092.875),
        ("inter_3b", 2092.875, 2354.484375),
        ("mode_4", 2354.484375, 2616.09375),
        ("inter_4a", 2616.09375, 2790.5),
        ("inter_4b", 2790.5, 2964.90625),
        ("inter_4c", 2964.90625, 3139.3125),
        ("mode_5", 3139.3125, 3575.328125),
    )


def _masked_stats(arr: torch.Tensor, mask: torch.Tensor, prefix: str) -> Dict[str, torch.Tensor]:
    """mean/std/p50/p90/max over the frames in ``mask`` (..., T) of each row
    of ``arr`` (..., n_bands, T); zeros where no frame is in the mask
    (``features_spec.py:278-305``)."""
    cnt = mask.sum(-1)
    m = mask[..., None, :]
    any_ = (cnt > 0)[..., None]
    cntf = torch.clamp(cnt, min=1).to(torch.float32)[..., None]
    mean = torch.sum(torch.where(m, arr, 0.0), dim=-1) / cntf
    var = torch.sum(torch.where(m, (arr - mean[..., None]) ** 2, 0.0), dim=-1) / cntf
    std = torch.sqrt(var)
    big = torch.finfo(arr.dtype).max
    xs = torch.sort(torch.where(m, arr, big), dim=-1).values

    def q_at(q):
        h = q * torch.clamp(cnt - 1, min=0).to(torch.float32)
        lo_i, hi_i = torch.floor(h).to(torch.int64), torch.ceil(h).to(torch.int64)
        fr = (h - lo_i.to(torch.float32))[..., None]
        shape = xs.shape[:-1] + (1,)
        v_lo = torch.gather(xs, -1, lo_i[..., None, None].expand(shape))[..., 0]
        v_hi = torch.gather(xs, -1, hi_i[..., None, None].expand(shape))[..., 0]
        return v_lo + fr * (v_hi - v_lo)

    mx = torch.amax(torch.where(m, arr, -big), dim=-1)
    return {
        f"{prefix}_mean": torch.where(any_, mean, 0.0),
        f"{prefix}_std": torch.where(any_, std, 0.0),
        f"{prefix}_p50": torch.where(any_, q_at(0.5), 0.0),
        f"{prefix}_p90": torch.where(any_, q_at(0.9), 0.0),
        f"{prefix}_max": torch.where(any_, mx, 0.0),
    }


def clip_spectral_occupancy(
    raw_power: torch.Tensor,
    frame_is_rain: torch.Tensor,
    *,
    fs: int,
    n_fft: int,
    bands: Optional[Tuple[Tuple[str, float, float], ...]] = None,
    eps: float = 1e-12,
) -> Dict[str, torch.Tensor]:
    """Clip-level per-band occupancy statistics split by rain / no-rain
    frames (``features_spec.py:239-317``).  ``raw_power`` (..., F, T),
    ``frame_is_rain`` (..., T); each statistic is (..., n_bands).  The band
    sums are float32 matrix products with a 0/1 band matrix."""
    if bands is None:
        bands = default_spectral_occupancy_bands()
    bands = tuple((str(nm), float(lo), float(hi)) for nm, lo, hi in bands)
    freqs = fft_frequencies(fs, n_fft)
    n_bands = len(bands)
    T = raw_power.shape[-1]
    lead = raw_power.shape[:-2]

    def make():
        masks = [((freqs >= lo) & (freqs <= hi)) if i == n_bands - 1
                 else ((freqs >= lo) & (freqs < hi))
                 for i, (_, lo, hi) in enumerate(bands)]
        return (np.stack(masks), np.asarray([lo for _, lo, _ in bands]),
                np.asarray([hi for _, _, hi in bands]))

    sel, band_lo, band_hi = device_constant(("occupancy_bands", bands, fs, n_fft),
                                            raw_power.device, make)
    band_power = torch.matmul(sel, raw_power.to(torch.float32))  # (..., n_bands, T)
    total = torch.sum(band_power, dim=-2) + eps
    log_power = torch.log1p(torch.clamp(band_power, min=0.0))
    ratio = band_power / total[..., None, :]

    rain = frame_is_rain.to(torch.bool)
    n_rain = rain.sum(-1, dtype=torch.int32)
    out: Dict[str, torch.Tensor] = {
        "band_lo_hz": band_lo.expand(lead + (n_bands,)),
        "band_hi_hz": band_hi.expand(lead + (n_bands,)),
        "rain_frame_count": n_rain,
        "no_rain_frame_count": T - n_rain,
    }
    out.update(_masked_stats(log_power, rain, "rain_log_power"))
    out.update(_masked_stats(ratio, rain, "rain_power_ratio"))
    out.update(_masked_stats(log_power, ~rain, "no_rain_log_power"))
    out.update(_masked_stats(ratio, ~rain, "no_rain_power_ratio"))
    return out
