"""Spectral-noise rain detector engine, classifier-only path, batched.

Counterpart of ``audio_processing_tools_tpu/models/spectral_noise.py``:
``SpectralNoiseEngine._trace_single`` with ``classifier_only_mode=True``
(``:205-344``), ``process`` / ``process_batch`` (``:444-461``),
``clip_aggregate`` (``:469-493``) and ``RainDetectorProcessor.run`` /
``run_batch`` (``:496-650``).

The JAX engine vmaps a one-clip program; this one runs the batch ``(B, N)``
as tensors with a leading clip axis, on the device of its input:

  1. TD prefilter ``sosfiltfilt`` (high-pass 350 Hz, order 4), computed
     once and reused as the engine's ``x_proc`` when the designs agree;
  2. the power spectrogram (kernel K1 on the card);
  3. the detector's noise PSD on the operating band (kernel K2);
  4. the normalized-dB detector input, band rows only;
  5. the frame classifier (kernel K3 inside).

``x_proc`` is computed only for audio outputs, the complex STFT only for
spectra or audio outputs.  The suppressor path (``classifier_only_mode=False``)
raises ``NotImplementedError`` (ROADMAP P10).
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from audio_processing_tools_tpu_torch.config import NoiseConfig, build_noise_config
from audio_processing_tools_tpu_torch.models.frame_classifier import (
    BandGeometry,
    FrameClass,
    build_prefilter_sos,
    detect_from_band,
    td_prefilter_sos,
)
from audio_processing_tools_tpu_torch.ops.filters import sosfiltfilt
from audio_processing_tools_tpu_torch.ops.spectrogram import spectrogram_power
from audio_processing_tools_tpu_torch.ops.stft import fft_frequencies, stft
from audio_processing_tools_tpu_torch.ops.trackers import (
    causal_time_mean,
    causal_time_median,
    make_psd_params,
    noise_psd_track,
)


class SpectralNoiseEngine:
    """Config-bound detector engine on one device.

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
        """The classifier-only engine on a float ``(B, N)`` batch."""
        cfg = self.cfg
        if not cfg.classifier_only_mode:
            raise NotImplementedError(
                "classifier_only_mode=False: the suppressor path is not ported "
                "yet (ROADMAP P10)")
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
        P_band = P[:, band_rows[0] : band_rows[-1] + 1, :]

        keep_det_debug = bool(cfg.return_detector_debug or cfg.debug_enable)
        if cfg.dflag("bypass_classifier", False):
            frame_class = torch.zeros((B, T), dtype=torch.int8, device=x.device)
            rain_conf = torch.zeros((B, T), dtype=torch.float32, device=x.device)
            noise_conf = torch.ones((B, T), dtype=torch.float32, device=x.device)
            det_debug = {"frame_class": frame_class, "rain_conf": rain_conf,
                         "noise_conf": noise_conf}
            feature_dump: Dict[str, Any] = {}
        else:
            P_det = self._detector_input(P_band, sr)
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
        if needs_audio:
            out["x_filt"] = x_proc
            out["y"] = x_proc
        if cfg.return_spectra:
            out["S"] = S
            out["S_hat"] = S
        return out

    def _detector_input(self, P_band: torch.Tensor, sr: int) -> torch.Tensor:
        """Normalized-dB detector input on the band rows
        (``spectral_noise.py:250-302``): the noise PSD tracked with no rain
        exclusion, lagged one frame and clamped to ``maxr * P``."""
        cfg = self.cfg
        eps = cfg.eps
        if not cfg.dflag("detector_use_noise_norm", True):
            return 10.0 * torch.log10(P_band + eps)
        B, K, T = P_band.shape
        params = make_psd_params(
            cfg_q=cfg.q, win_sec=cfg.win_sec, frames_per_sec=float(sr) / float(cfg.hop),
            ema_up=cfg.ema_up, ema_down=cfg.ema_down, eps=cfg.eps,
            noise_psd_max_ratio=cfg.noise_psd_max_ratio,
            adaptive_q_enable=cfg.adaptive_q_enable,
            adaptive_q_min=cfg.adaptive_q_min,
            adaptive_q_alpha=cfg.adaptive_q_alpha,
        )
        P_track = P_band
        L = int(cfg.pre_smooth_frames)
        if L and L > 1:
            P_track = causal_time_mean(P_track, L)
        no_rain = torch.zeros((B, T), dtype=torch.bool, device=P_band.device)
        N_band = noise_psd_track(P_track, no_rain, params)
        m = int(cfg.median_frames)
        if m and m > 1:
            N_band = causal_time_median(N_band, m)
        lag = torch.roll(N_band, 1, dims=-1)
        if T > 1:
            lag[..., 0] = N_band[..., 0]
        maxr = float(cfg.noise_psd_max_ratio)
        maxr = 1.0 if not np.isfinite(maxr) else float(np.clip(maxr, 0.0, 1.0))
        lag = torch.minimum(lag, maxr * P_band)
        if str(cfg.detector_noise_norm_mode).lower() == "ratio_db":
            return 10.0 * torch.log10(P_band / (lag + eps) + eps)
        return 10.0 * torch.log10(P_band + eps) - 10.0 * torch.log10(lag + eps)

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
        return _to_numpy(out, index=0)

    def process_batch(self, xb, sr: Optional[int] = None) -> Dict[str, Any]:
        """A ``(B, N)`` batch; returns tensors on the batch's device."""
        sr = self._sr(sr)
        if not isinstance(xb, torch.Tensor):
            xb = torch.as_tensor(np.asarray(xb, np.float32), device=self.device)
        if xb.dim() != 2:
            raise ValueError(f"expected a (B, N) batch, got shape {tuple(xb.shape)}")
        return self._run(xb, sr)


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
        return json.dumps(params, sort_keys=True, default=str)

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
        if keep_debug and "det_debug" in out:
            state["det_debug"] = out["det_debug"]
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
        host = _to_numpy({k: out[k] for k in ("frame_class", "rain_conf", "noise_conf",
                                              "times", "features") if k in out})
        latency = (time.perf_counter() - t0) / max(B, 1)

        cmin = int(p.get("clip_rain_min_frames", 1))
        pairs = []
        for i in range(B):
            fc = host["frame_class"][i]
            rc = host["rain_conf"][i]
            agg = clip_aggregate(fc, rc, cmin)
            metrics: Dict[str, Any] = {**agg, "latency_s": latency}
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
