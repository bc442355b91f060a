"""Spectral-noise rain detector and suppressor engine, batched.

Counterpart of ``audio_processing_tools_tpu/models/spectral_noise.py``:
``_mode_union_mask`` (``:48-62``), ``gain_freq_stage`` (``:68-124``),
``gain_time_step`` / ``compute_gain`` (``:127-178``),
``SpectralNoiseEngine._trace_single`` (``:205-429``), ``process`` /
``process_batch`` (``:444-461``), ``clip_aggregate`` (``:469-493``) and
``RainDetectorProcessor.run`` / ``run_batch`` (``:496-650``).

The JAX engine vmaps a one-clip program; this one runs the batch ``(B, N)``
as tensors with a leading clip axis, on the device of its input:

  1. TD prefilter ``sosfiltfilt`` (high-pass 350 Hz, order 4), computed
     once and reused as the engine's ``x_proc`` when the designs agree;
  2. the power spectrogram (kernel K1 on the card), or the complex STFT
     when spectra or audio leave the engine;
  3. the detector's noise PSD on the operating band (kernel K2);
  4. the normalized-dB detector input, band rows only;
  5. the frame classifier (kernel K3 inside);
  6. unless ``classifier_only_mode``: the suppressor's noise PSD, tracked
     only on noise frames (K2 again), the noise-floor metrics and, when
     ``S_hat``, ``y`` or ``debug["G"]`` leaves the engine, the gain (its
     temporal smoothing is kernel K5), ``S_hat = G * S`` and the ISTFT.

XLA drops what no output reads; eager PyTorch computes whatever it is
given, so this engine skips that work by design: ``x_proc`` only for audio
outputs, the complex STFT only for spectra or audio, the gain only for the
outputs that carry it.
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as tnf

from audio_processing_tools_tpu_torch import _kernels
from audio_processing_tools_tpu_torch.config import NoiseConfig, build_noise_config
from audio_processing_tools_tpu_torch.models.frame_classifier import (
    BandGeometry,
    FrameClass,
    build_prefilter_sos,
    detect_from_band,
    td_prefilter_sos,
)
from audio_processing_tools_tpu_torch.ops._device import device_constant, sorted_keys
from audio_processing_tools_tpu_torch.ops.filters import sosfiltfilt
from audio_processing_tools_tpu_torch.ops.spectrogram import spectrogram_power
from audio_processing_tools_tpu_torch.ops.stats import quantile_linear
from audio_processing_tools_tpu_torch.ops.stft import fft_frequencies, istft, stft
from audio_processing_tools_tpu_torch.ops.trackers import (
    causal_time_mean,
    causal_time_median,
    make_psd_params,
    noise_psd_track,
)


def _mode_union_mask(freqs_band: np.ndarray, mode_bands) -> np.ndarray:
    """Union of mode bands over band bins (``spectral_noise.py:48-62``)."""
    mask = np.zeros(freqs_band.shape[0], dtype=bool)
    if not isinstance(mode_bands, (list, tuple)):
        return mask
    for bb in mode_bands:
        try:
            lo, hi = float(bb[0]), float(bb[1])
        except Exception:
            continue
        if not (np.isfinite(lo) and np.isfinite(hi)) or hi <= lo:
            continue
        mask |= (freqs_band >= lo) & (freqs_band <= hi)
    return mask


_GAIN_NOISE_TH = 0.7  # noise-conf knee for adaptive oversubtraction


def gain_freq_stage(cfg: NoiseConfig, P_band: torch.Tensor, N_band: torch.Tensor,
                    noise_conf: torch.Tensor,
                    snr_gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-frame part of the suppression gain (``spectral_noise.py:68-124``):
    oversubtraction, the sqrt-sub or Wiener gain, and the frequency smoothing
    on noise-like frames.  ``P_band``, ``N_band`` (..., K, T); ``noise_conf``
    and ``snr_gate`` (..., T)."""
    eps = cfg.eps
    K = P_band.shape[-2]
    noise_conf = torch.clamp(noise_conf, 0.0, 1.0)
    adaptive = bool(cfg.adaptive_gain_enable)
    th = _GAIN_NOISE_TH
    denom = max(1e-9, 1.0 - th)

    if adaptive:
        # divided by a 0-dim tensor: on the card a Python divisor becomes a
        # reciprocal multiply, which is not the JAX program's (or K8's) rounding
        eff_noise = torch.clamp((noise_conf - th) / noise_conf.new_full((), denom), 0.0, 1.0)
        oversub = cfg.oversub_base + eff_noise * (cfg.oversub_max - cfg.oversub_base)
        if snr_gate is not None:
            oversub = oversub * (1.0 - torch.clamp(snr_gate, 0.0, 1.0))
    else:
        oversub = torch.full(noise_conf.shape, float(cfg.oversub_base),
                             dtype=P_band.dtype, device=P_band.device)
    oversub = oversub[..., None, :]

    if cfg.gain_mode.lower() == "wiener":
        G_raw = torch.clamp(P_band - oversub * N_band, min=0.0) / (P_band + eps)
    else:
        ratio = torch.clamp(N_band / (P_band + eps), 0.0, 1.0)
        G_raw = 1.0 - oversub * torch.sqrt(ratio)
    G_raw = torch.clamp(G_raw, cfg.gain_floor, cfg.gain_ceil)

    kernel = np.asarray(cfg.gain_freq_kernel, np.float32).reshape(-1)
    if kernel.size < 1:
        kernel = np.array([1.0], np.float32)
    kernel = kernel / (kernel.sum() + 1e-12)
    if not (bool(cfg.gain_freq_smooth_enable) and kernel.size > 1):
        return G_raw
    pad = kernel.size // 2
    Gp = tnf.pad(G_raw, (0, 0, pad, pad))
    G_conv = torch.zeros_like(G_raw)
    for i, kv in enumerate(kernel):
        G_conv = G_conv + float(kv) * Gp[..., i : i + K, :]
    if adaptive:
        return torch.where((noise_conf >= th)[..., None, :], G_conv, G_raw)
    return G_conv


class _GainConsts(NamedTuple):
    adaptive: bool
    th: float
    denom: float
    alpha_base: float
    floor: float
    ceil: float


def _gain_consts(cfg: NoiseConfig) -> _GainConsts:
    """The constants of ``gain_time_step`` (``spectral_noise.py:131-134``)."""
    return _GainConsts(
        adaptive=bool(cfg.adaptive_gain_enable), th=_GAIN_NOISE_TH,
        denom=max(1e-9, 1.0 - _GAIN_NOISE_TH),
        alpha_base=float(np.clip(cfg.gain_smooth_alpha, 0.0, 1.0)),
        floor=float(cfg.gain_floor), ceil=float(cfg.gain_ceil),
    )


def gain_time_step(cfg: NoiseConfig):
    """The causal temporal-smoothing EMA step, rain-frame protected when
    adaptive (``spectral_noise.py:127-147``): ``step(G_prev, G_f_t, nc_t)``
    with ``G_prev``, ``G_f_t`` (..., K) and ``nc_t`` (...,) returns ``G_t``.

    The division by ``denom`` takes it as a 0-dim tensor on the device of
    ``nc_t``: PyTorch's CUDA division by a Python number multiplies by its
    reciprocal, which is not the JAX program's (or the kernel's) rounding.
    """
    c = _gain_consts(cfg)

    def step(G_prev, G_f_t, nc_t):
        if c.adaptive:
            below = nc_t < c.th
            eff_nc = (nc_t - c.th) / nc_t.new_full((), c.denom)
            alpha_t = torch.where(below, 0.0, c.alpha_base * eff_nc)[..., None]
            G_t = alpha_t * G_prev + (1.0 - alpha_t) * G_f_t
            return torch.where(below[..., None], torch.maximum(G_t, G_f_t), G_t)
        return c.alpha_base * G_prev + (1.0 - c.alpha_base) * G_f_t

    return step


def _gain_time_smooth_plain(G_freq: torch.Tensor, noise_conf: torch.Tensor,
                            cfg: NoiseConfig) -> torch.Tensor:
    """The scan of ``spectral_noise.py:168-178`` as a loop over frames."""
    c = _gain_consts(cfg)
    step = gain_time_step(cfg)
    G = G_freq[..., 0]
    outs = [G]
    for t in range(1, G_freq.shape[-1]):
        G = step(G, G_freq[..., t], noise_conf[..., t])
        outs.append(G)
    return torch.clamp(torch.stack(outs, dim=-1), c.floor, c.ceil)


def _gain_time_smooth_cuda(G_freq: torch.Tensor, noise_conf: torch.Tensor,
                           cfg: NoiseConfig) -> torch.Tensor:
    K, T = G_freq.shape[-2:]
    G3 = G_freq.reshape(-1, K, T)
    nc = noise_conf.reshape(-1, T)
    _kernels.require_cuda("gain_time_smooth", G3, torch.float32, 3)
    _kernels.require_cuda("gain_time_smooth(noise_conf)", nc, torch.float32, 2)
    if nc.shape[0] != G3.shape[0] or nc.device != G3.device:
        raise ValueError("gain_time_smooth: noise_conf must be (..., T) beside G_freq (..., K, T)")
    c = _gain_consts(cfg)
    out = torch.empty_like(G3)
    lib = _kernels.build()
    with torch.cuda.device(G3.device):
        err = lib.lib.apt_gain_time_smooth(
            G3.data_ptr(), nc.data_ptr(), out.data_ptr(), G3.shape[0], K, T,
            int(c.adaptive), c.th, c.denom, c.alpha_base, 1.0 - c.alpha_base,
            c.floor, c.ceil, _kernels.stream_of(G3),
        )
    lib.check(err, "gain_time_smooth")
    _kernels.count("gain_time_smooth")
    return out.reshape(G_freq.shape)


def gain_time_smooth(G_freq: torch.Tensor, noise_conf: torch.Tensor,
                     cfg: NoiseConfig) -> torch.Tensor:
    """Temporal smoothing of the gain over the last axis, clipped to
    ``[gain_floor, gain_ceil]``: kernel K5 on a CUDA tensor, the plain loop
    on a CPU tensor.  ``G_freq`` (..., K, T); ``noise_conf`` (..., T),
    already clipped to [0, 1]."""
    G_freq = G_freq.to(torch.float32)
    noise_conf = noise_conf.to(torch.float32)
    if G_freq.shape[-1] == 0:
        return G_freq.clone()
    if G_freq.device.type == "cpu":
        return _gain_time_smooth_plain(G_freq, noise_conf, cfg)
    return _gain_time_smooth_cuda(G_freq.contiguous(), noise_conf.contiguous(), cfg)


def compute_gain(cfg: NoiseConfig, P_band: torch.Tensor, N_band: torch.Tensor,
                 noise_conf: torch.Tensor,
                 snr_gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Adaptive suppression gain (``spectral_noise.py:150-178``)."""
    noise_conf = torch.clamp(noise_conf, 0.0, 1.0)
    G_freq = gain_freq_stage(cfg, P_band, N_band, noise_conf, snr_gate)
    return gain_time_smooth(G_freq, noise_conf, cfg)


def _lagged(N: torch.Tensor) -> torch.Tensor:
    """``N`` one frame late along the last axis, frame 0 repeated."""
    lag = torch.roll(N, 1, dims=-1)
    if N.shape[-1] > 1:
        lag[..., 0] = N[..., 0]
    return lag


def _max_ratio(cfg: NoiseConfig) -> float:
    """``noise_psd_max_ratio`` clipped to [0, 1], 1 when not finite."""
    maxr = float(cfg.noise_psd_max_ratio)
    return 1.0 if not np.isfinite(maxr) else float(np.clip(maxr, 0.0, 1.0))


def _full_rows(band: torch.Tensor, F: int, rows: slice) -> torch.Tensor:
    """Band rows ``(..., K, T)`` scattered into zeros ``(..., F, T)``."""
    full = band.new_zeros(band.shape[:-2] + (F, band.shape[-1]))
    full[..., rows, :] = band
    return full


class SpectralNoiseEngine:
    """Config-bound engine on one device.

    ``process(x, sr)`` returns the one-clip output dict as NumPy arrays;
    ``process_batch(xb, sr)`` runs a ``(B, N)`` batch and returns tensors on
    the batch's device.  NumPy input is placed on ``device``; there is no
    implicit move to another device.
    """

    def __init__(self, config: Optional[NoiseConfig] = None,
                 device: str | torch.device = "cuda"):
        self.cfg = config
        self.device = torch.device(device)
        self._is_setup = config is not None
        if self._is_setup:
            self.cfg.validate()

    def setup(self, params: Dict[str, Any]) -> None:
        if self._is_setup:
            return
        sr = int(params.get("sample_rate", params.get("fs", 11162)))
        self.cfg = build_noise_config(sr, params)
        self.cfg.validate()
        self._is_setup = True

    # ------------------------------------------------------------------
    def _run(self, x: torch.Tensor, sr: int) -> Dict[str, Any]:
        """The engine on a float ``(B, N)`` batch."""
        cfg = self.cfg
        x = x.to(torch.float32)
        B = x.shape[0]

        geo = BandGeometry(cfg)
        td_sos = td_prefilter_sos(cfg)
        x_td = sosfiltfilt(td_sos, x) if td_sos is not None else x

        needs_audio = bool(cfg.return_filtered_audio or cfg.compute_output_audio)
        x_proc = x
        if needs_audio:
            mode = str(cfg.pre_filter_mode).lower()
            if mode not in ("highpass", "bandpass", "none"):
                mode = "highpass"
            sos = build_prefilter_sos(cfg, sr, mode) if mode != "none" else None
            if sos is not None and td_sos is not None and np.array_equal(sos, td_sos):
                x_proc = x_td  # the same high-pass on the same x: computed once
            elif sos is not None:
                x_proc = sosfiltfilt(sos, x)

        needs_complex = bool(cfg.return_spectra or needs_audio)
        if needs_complex:
            S = stft(x, n_fft=cfg.n_fft, hop=cfg.hop, center=True)
            P = (S.real * S.real + S.imag * S.imag).contiguous()
        else:
            S = None
            P = spectrogram_power(x, n_fft=cfg.n_fft, hop=cfg.hop, center=True)
        T = P.shape[-1]

        freqs = fft_frequencies(sr, cfg.n_fft)
        band_rows = np.flatnonzero((freqs >= cfg.operating_band[0])
                                   & (freqs <= cfg.operating_band[1]))
        if not np.array_equal(band_rows, geo.band_rows):
            raise ValueError(
                f"sample rate {sr} puts the operating band on other bins than "
                f"the configured fs={cfg.fs}")
        # the operating band is one run of rows, so this is a view
        rows = slice(int(band_rows[0]), int(band_rows[-1]) + 1)
        P_band = P[:, rows, :]

        keep_det_debug = bool(cfg.return_detector_debug or cfg.debug_enable)
        det_noise = (None, None)
        if cfg.dflag("bypass_classifier", False):
            frame_class = torch.zeros((B, T), dtype=torch.int8, device=x.device)
            rain_conf = torch.zeros((B, T), dtype=torch.float32, device=x.device)
            noise_conf = torch.ones((B, T), dtype=torch.float32, device=x.device)
            det_debug = {"frame_class": frame_class, "rain_conf": rain_conf,
                         "noise_conf": noise_conf}
            feature_dump: Dict[str, Any] = {}
        else:
            P_det, det_noise = self._detector_input(P_band, sr)
            frame_class, rain_conf, det_debug, feature_dump = detect_from_band(
                cfg, geo, P_det, x_td, P,
                debug=keep_det_debug)
            noise_conf = det_debug["noise_conf"]

        # frames_to_time in float64 on the device: no host copy per batch
        times = (torch.arange(T, dtype=torch.float64, device=x.device)
                 * (float(cfg.hop) / float(sr))).to(torch.float32).expand(B, T)
        out: Dict[str, Any] = {
            "frame_class": frame_class,
            "rain_conf": rain_conf,
            "noise_conf": noise_conf,
            "times": times,
        }
        if cfg.dump_features:
            out["features"] = {
                "frame_times": times,
                "frame_class": frame_class,
                "is_rain": frame_class == int(FrameClass.RAIN),
                "rain_conf": rain_conf,
                "noise_conf": noise_conf,
                **feature_dump,
            }
        if keep_det_debug:
            out["det_debug"] = det_debug
        if cfg.classifier_only_mode:
            if needs_audio:
                out["x_filt"] = x_proc
                out["y"] = x_proc
            if cfg.return_spectra:
                out["S"] = S
                out["S_hat"] = S
            return out

        # ---------------- suppressor path (``spectral_noise.py:346-429``) ----------------
        eps = cfg.eps
        F = P.shape[-2]
        is_noise = frame_class == int(FrameClass.NOISE)
        is_rain_for_psd = ~is_noise
        want_debug = bool(cfg.return_debug or cfg.debug_enable)
        # G is computed only for the outputs that carry it: S_hat, y, debug
        needs_gain = bool(cfg.return_spectra or cfg.compute_output_audio or want_debug)
        G = snr_gate = snr_mode = None
        y = None
        if cfg.suppressor_bypass:
            N_band = torch.zeros_like(P_band)
            if needs_gain:
                G = torch.ones_like(P)
            S_hat = S  # None when the complex STFT was skipped
            if cfg.compute_output_audio:
                y = x_proc
        else:
            N_band = self._noise_psd_band(P_band, is_rain_for_psd, sr)
            S_hat = None
            if needs_gain:
                N_lag = _lagged(N_band) if bool(cfg.use_lagged_noise_psd) and T > 1 else N_band
                N_eff = torch.minimum(N_lag, _max_ratio(cfg) * P_band)
                if bool(cfg.snr_gating_enable):
                    snr_mode, snr_gate = self._snr_gate(P_band, N_eff, freqs[band_rows])
                G = torch.ones_like(P)
                G[:, rows, :] = compute_gain(cfg, P_band, N_eff, noise_conf, snr_gate)
                if S is not None:
                    S_hat = G * S
                if cfg.compute_output_audio:
                    y = istft(S_hat, n_fft=cfg.n_fft, hop=cfg.hop, length=x.shape[-1],
                              center=True)

        noise_db = 10.0 * torch.log10(N_band + eps)
        out["mean_noise_floor_db"] = torch.mean(noise_db, dim=(-2, -1))
        out["median_noise_floor_db"] = quantile_linear(noise_db.reshape(B, -1), 0.5)

        if cfg.return_noise_psd or cfg.debug_enable or want_debug:
            noise_psd = _full_rows(N_band, F, rows)
        if cfg.return_noise_psd or cfg.debug_enable:
            out["noise_psd"] = noise_psd
        if want_debug:
            det_N, det_lag = det_noise
            freqs_band = freqs[band_rows]
            out["debug"] = {
                "use_for_noise_psd": is_noise,
                "is_rain_for_psd": is_rain_for_psd,
                "G": G,
                "noise_psd": noise_psd,
                "snr_mode": snr_mode,
                "snr_gate": snr_gate,
                "detector_noise_psd": None if det_N is None else _full_rows(det_N, F, rows),
                "detector_noise_psd_lag": None if det_lag is None else _full_rows(det_lag, F, rows),
                "P_band_all": P_band,
                "N_band_all": N_band,
                "freqs_band": device_constant(("freqs_band", freqs_band.tobytes()), x.device,
                                              lambda: freqs_band).expand(B, -1),
            }
        if cfg.return_spectra:
            out["S"] = S
            out["S_hat"] = S_hat
        if needs_audio:
            out["x_filt"] = x_proc
            out["y"] = y
            out["y_suppressed"] = y
        return out

    def _psd_params(self, sr: int):
        cfg = self.cfg
        return make_psd_params(
            cfg_q=cfg.q, win_sec=cfg.win_sec, frames_per_sec=float(sr) / float(cfg.hop),
            ema_up=cfg.ema_up, ema_down=cfg.ema_down, eps=cfg.eps,
            noise_psd_max_ratio=cfg.noise_psd_max_ratio,
            adaptive_q_enable=cfg.adaptive_q_enable,
            adaptive_q_min=cfg.adaptive_q_min,
            adaptive_q_alpha=cfg.adaptive_q_alpha,
        )

    def _noise_psd_band(self, P_band: torch.Tensor, is_rain: torch.Tensor,
                        sr: int) -> torch.Tensor:
        """The noise PSD on the band rows (``spectral_noise.py:250-263``):
        optional causal pre-smoothing, the tracker (kernel K2 on the card)
        with ``is_rain`` frames excluded, optional causal median."""
        cfg = self.cfg
        P_track = P_band
        L = int(cfg.pre_smooth_frames)
        if L and L > 1:
            P_track = causal_time_mean(P_track, L)
        N_band = noise_psd_track(P_track, is_rain, self._psd_params(sr))
        m = int(cfg.median_frames)
        if m and m > 1:
            N_band = causal_time_median(N_band, m)
        return N_band

    def _detector_input(self, P_band: torch.Tensor, sr: int):
        """Normalized-dB detector input on the band rows
        (``spectral_noise.py:285-302``): the noise PSD tracked with no rain
        exclusion, lagged one frame and clamped to ``maxr * P``.  Returns
        ``(P_det, (N_band, lag))``, the pair ``(None, None)`` without the
        normalization."""
        cfg = self.cfg
        eps = cfg.eps
        if not cfg.dflag("detector_use_noise_norm", True):
            return 10.0 * torch.log10(P_band + eps), (None, None)
        B, K, T = P_band.shape
        no_rain = torch.zeros((B, T), dtype=torch.bool, device=P_band.device)
        N_band = self._noise_psd_band(P_band, no_rain, sr)
        lag = torch.minimum(_lagged(N_band), _max_ratio(cfg) * P_band)
        if str(cfg.detector_noise_norm_mode).lower() == "ratio_db":
            P_det = 10.0 * torch.log10(P_band / (lag + eps) + eps)
        else:
            P_det = 10.0 * torch.log10(P_band + eps) - 10.0 * torch.log10(lag + eps)
        return P_det, (N_band, lag)

    def _snr_gate(self, P_band: torch.Tensor, N_eff: torch.Tensor,
                  freqs_band: np.ndarray):
        """Mode-band SNR and the gate it gives (``spectral_noise.py:369-386``);
        the band sums are float32 matrix products with a 0/1 row."""
        cfg = self.cfg
        mode_bands = ((cfg.detector or {}).get("mode_bands", None)
                      if bool(cfg.snr_gating_use_mode_bands) else None)
        K = freqs_band.shape[0]
        mm = (_mode_union_mask(freqs_band, mode_bands) if mode_bands is not None
              else np.ones(K, bool))
        if not mm.any():
            mm = np.ones(K, bool)
        row = device_constant(("snr_mode_mask", mm.tobytes()), P_band.device,
                              lambda: mm[None, :])
        Pm = torch.matmul(row, P_band)[..., 0, :]
        Nm = torch.matmul(row, N_eff)[..., 0, :]
        snr_mode = Pm / (Nm + cfg.eps)
        gate = snr_mode / (snr_mode + max(1e-9, float(cfg.snr_gating_snr1)))
        pwr = float(cfg.snr_gating_power)
        if pwr != 1.0 and np.isfinite(pwr) and pwr > 0.0:
            gate = torch.pow(torch.clamp(gate, 0.0, 1.0), pwr)
        return snr_mode, torch.clamp(gate, 0.0, 1.0)

    # ------------------------------------------------------------------
    def _sr(self, sr: Optional[int]) -> int:
        if self.cfg is None:
            self.setup({"sample_rate": sr or 11162})
        return int(self.cfg.fs if sr is None else sr)

    def process(self, x, sr: Optional[int] = None) -> Dict[str, Any]:
        """One clip; returns a dict of NumPy arrays."""
        sr = self._sr(sr)
        if isinstance(x, torch.Tensor):
            xt = x.reshape(1, -1)
        else:
            xt = torch.as_tensor(np.asarray(x, np.float32).reshape(1, -1), device=self.device)
        out = self._run(xt, sr)
        return _to_numpy(sorted_keys(out), index=0)

    def process_batch(self, xb, sr: Optional[int] = None) -> Dict[str, Any]:
        """A ``(B, N)`` batch; returns tensors on the batch's device."""
        sr = self._sr(sr)
        if not isinstance(xb, torch.Tensor):
            xb = torch.as_tensor(np.asarray(xb, np.float32), device=self.device)
        if xb.dim() != 2:
            raise ValueError(f"expected a (B, N) batch, got shape {tuple(xb.shape)}")
        return sorted_keys(self._run(xb, sr))


def _to_numpy(tree, index: Optional[int] = None):
    """Tensors of a nested output dict to NumPy (optionally one clip)."""
    if isinstance(tree, dict):
        return {k: _to_numpy(v, index) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        t = tree[index] if index is not None else tree
        return t.detach().cpu().numpy()
    return tree


# ---------------------------------------------------------------------------
# Framework adapter
# ---------------------------------------------------------------------------


def clip_aggregate(frame_class: np.ndarray, rain_conf: np.ndarray,
                   clip_rain_min_frames: int = 1) -> Dict[str, Any]:
    """Clip-level aggregation (``spectral_noise.py:469-493``)."""
    frame_is_rain = np.asarray(frame_class, np.int8) == int(FrameClass.RAIN)
    cmin = max(1, int(clip_rain_min_frames))
    count = int(frame_is_rain.sum())
    frac = float(frame_is_rain.mean()) if frame_is_rain.size else 0.0
    clip_is_rain = bool(count >= cmin)
    rc = np.asarray(rain_conf, np.float32).reshape(-1)
    if count > 0 and rc.size == frame_is_rain.size:
        median_conf = float(np.median(rc[frame_is_rain]))
    else:
        median_conf = 0.0
    abundance_ref = max(2 * cmin, 1)
    abundance_conf = float(np.clip(count / float(abundance_ref), 0.0, 1.0))
    return {
        "rain_frame_fraction": frac,
        "clip_rain_fraction": frac,
        "rain_frame_count": count,
        "clip_is_rain": clip_is_rain,
        "clip_rain_conf": float(max(median_conf, abundance_conf)),
        "median_rain_conf": median_conf,
        "clip_rain_min_frames": cmin,
    }


class RainDetectorProcessor:
    """Framework-facing processor; caches one configured engine per
    parameter set.  Engines run on ``device``."""

    def __init__(self, name: str = "rain_detector", device: str | torch.device = "cuda"):
        self.name = name
        self.device = torch.device(device)
        self._cache: Dict[str, SpectralNoiseEngine] = {}

    @staticmethod
    def _key(params: Dict[str, Any]) -> str:
        try:
            return json.dumps(params, sort_keys=True, default=str)
        except (TypeError, ValueError):  # e.g. tuple keys, or keys that do not sort
            return repr(sorted(params.items(), key=lambda kv: kv[0]))

    def _engine(self, params: Dict[str, Any]) -> SpectralNoiseEngine:
        key = self._key(params)
        eng = self._cache.get(key)
        if eng is None:
            eng = SpectralNoiseEngine(device=self.device)
            eng.setup(params)
            self._cache[key] = eng
        return eng

    def run(self, audio_data, params: Dict[str, Any]
            ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """One 1-D clip -> ``(metrics, state)`` (``spectral_noise.py:520-591``)."""
        audio_data = np.asarray(audio_data)
        if audio_data.ndim != 1:
            raise ValueError(f"audio_data must be 1-D, got {audio_data.shape}")
        sr_chk = params.get("sample_rate")
        dur_chk = params.get("check_duration")
        if sr_chk is not None and dur_chk is not None:
            if audio_data.size < int(sr_chk * dur_chk):
                raise ValueError(
                    f"audio_data too short: {audio_data.size} < {int(sr_chk * dur_chk)}")

        p = dict(params)
        keep_audio = bool(p.get("keep_state_audio", False))
        keep_spectra = bool(p.get("keep_state_spectra", False))
        keep_debug = bool(p.get("keep_state_debug", False))
        keep_features = bool(p.get("keep_state_features", True))
        p.setdefault("compute_output_audio", keep_audio)
        p.setdefault("return_filtered_audio", keep_audio)
        p.setdefault("return_spectra", keep_spectra)
        p.setdefault("return_debug", keep_debug)
        p.setdefault("return_detector_debug", keep_debug)
        p.setdefault("return_noise_psd", keep_debug)

        sample_rate = int(p.get("sample_rate", 11162))
        eng = self._engine(p)

        t0 = time.perf_counter()
        out = eng.process(audio_data, sr=sample_rate)
        latency = time.perf_counter() - t0

        agg = clip_aggregate(
            out.get("frame_class", np.zeros(0, np.int8)),
            out.get("rain_conf", np.zeros(0, np.float32)),
            int(p.get("clip_rain_min_frames", 1)),
        )
        metrics: Dict[str, Any] = {**agg, "latency_s": latency}
        if "mean_noise_floor_db" in out:
            metrics["mean_noise_floor_db"] = float(out["mean_noise_floor_db"])
            metrics["median_noise_floor_db"] = float(out["median_noise_floor_db"])
        state: Dict[str, Any] = {
            "frame_class": out.get("frame_class"),
            "times": out.get("times"),
            "rain_conf": out.get("rain_conf"),
            "noise_conf": out.get("noise_conf"),
            **agg,
            "latency_s": latency,
            "processor": self.name,
        }
        if keep_features:
            state["features"] = out.get("features")
        if keep_debug:
            for k in ("debug", "det_debug", "noise_psd"):
                if k in out:
                    state[k] = out[k]
        if keep_spectra:
            state["S"] = out.get("S")
            state["S_hat"] = out.get("S_hat")
        if keep_audio:
            state["input_audio"] = audio_data
            if "x_filt" in out:
                state["filtered_audio"] = out["x_filt"]
            if "y" in out:
                state["output_audio"] = out["y"]
        if bool(p.get("keep_state_config", False)):
            state["config"] = eng.cfg
        return metrics, state

    def run_batch(self, audio_matrix, params: Dict[str, Any]) -> list:
        """A ``(B, N)`` batch (NumPy, or a tensor already on its device) ->
        ``[(metrics, state), ...]`` per clip (``spectral_noise.py:593-650``)."""
        if not isinstance(audio_matrix, torch.Tensor):
            audio_matrix = np.asarray(audio_matrix, np.float32)
        if audio_matrix.ndim != 2:
            raise ValueError(f"audio_matrix must be 2-D, got {tuple(audio_matrix.shape)}")
        B = audio_matrix.shape[0]

        p = dict(params)
        keep_features = bool(p.get("keep_state_features", True))
        for flag, default in (
            ("compute_output_audio", False), ("return_filtered_audio", False),
            ("return_spectra", False), ("return_debug", False),
            ("return_detector_debug", False), ("return_noise_psd", False),
        ):
            p.setdefault(flag, bool(p.get("keep_state_debug", False)) or default)

        sample_rate = int(p.get("sample_rate", 11162))
        eng = self._engine(p)
        t0 = time.perf_counter()
        out = eng.process_batch(audio_matrix, sr=sample_rate)
        host = _to_numpy({k: out[k] for k in (
            "frame_class", "rain_conf", "noise_conf", "times", "features",
            "mean_noise_floor_db", "median_noise_floor_db") if k in out})
        latency = (time.perf_counter() - t0) / max(B, 1)

        cmin = int(p.get("clip_rain_min_frames", 1))
        pairs = []
        for i in range(B):
            fc = host["frame_class"][i]
            rc = host["rain_conf"][i]
            agg = clip_aggregate(fc, rc, cmin)
            metrics: Dict[str, Any] = {**agg, "latency_s": latency}
            if "mean_noise_floor_db" in host:
                metrics["mean_noise_floor_db"] = float(host["mean_noise_floor_db"][i])
                metrics["median_noise_floor_db"] = float(host["median_noise_floor_db"][i])
            state: Dict[str, Any] = {
                "frame_class": fc,
                "times": host["times"][i],
                "rain_conf": rc,
                "noise_conf": host["noise_conf"][i],
                **agg,
                "latency_s": latency,
                "processor": self.name,
            }
            if keep_features and "features" in host:
                state["features"] = {k: v[i] for k, v in host["features"].items()}
            pairs.append((metrics, state))
        return pairs
