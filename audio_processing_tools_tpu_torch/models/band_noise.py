"""The firmware-shaped band-noise estimator, batched over clips or streams.

Counterpart of ``audio_processing_tools_tpu/models/band_noise.py``.  The
estimator is sequential per frame (filter state, detector holds, a ring
buffer of noise samples with a TTL, a quantile and an EMA, telemetry
accumulators).  Per call, for B clips or streams at once:

  * the high-pass and band-pass filters run over the whole call as the
    cascade with the sequential block boundary
    (:func:`~audio_processing_tools_tpu_torch.ops.filters.cascade_sosfilt`,
    kernel K4 on the card), seeded from the raw first sample while a stream
    is not seeded; frames are contiguous (``hop == frame_len``), so
    filtering the whole call is filtering frame by frame;
  * the per-frame inputs are elementwise arithmetic and fixed-order sums
    (:func:`~audio_processing_tools_tpu_torch.ops.stats.tree_sum`), the
    frame power an unwindowed rFFT (``spectrogram_power(window="rect")``,
    kernel K1 on the card);
  * the estimator's per-frame scan is :func:`_run_band_scan`: kernel K6
    (``csrc/band_noise.cu``) on a CUDA tensor, its plain loop
    :func:`_band_scan_plain` on a CPU tensor.

**Bit contract** (the JAX module's own, ``band_noise.py:195-197, 296-297``):
whole clip, any chunking in multiples of ``frame_len``, frame by frame, a
batch and each stream alone give the same bits, on the CPU and on the card.
No sum whose bits matter is a torch reduction or a library product.

The estimator has no weights: its state (:func:`band_noise_init_state`, a
dict with the JAX package's keys and a leading stream axis) is what carries
across calls, frameworks (:func:`state_from_jax` / :func:`state_to_jax`)
and connections (:func:`stack_states` / :func:`split_state`).
"""

from __future__ import annotations

import ctypes
import functools
import time
from dataclasses import dataclass, field
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from audio_processing_tools_tpu_torch import _kernels
from audio_processing_tools_tpu_torch.ops._device import device_constant, sorted_keys
from audio_processing_tools_tpu_torch.ops.filters import butter_sos, cascade_sosfilt, sosfilt_zi
from audio_processing_tools_tpu_torch.ops.spectrogram import spectrogram_power
from audio_processing_tools_tpu_torch.ops.stats import (
    masked_quantile_rankselect,
    quantile_linear,
    tree_sum,
)

EPS = 1e-12
State = Dict[str, Any]


def hz_to_bin(f_hz: float, fs: float, n_fft: int) -> int:
    """(``band_noise.py:45-47``)."""
    return int(np.clip(np.round(f_hz * n_fft / fs), 0, n_fft // 2))


def db_to_ratio(db: float) -> float:
    return 10.0 ** (db / 10.0)


@dataclass(frozen=True)
class NoiseFrameDetectorConfig:
    """The frame detector's settings (``band_noise.py:54-75``)."""

    fs: int = 11162
    n_fft: int = 512
    M_db: float = 6.0
    N_db: float = 3.0
    primary_hz: Tuple[float, float] = (450.0, 650.0)
    rain_bands_hz: Tuple[Tuple[float, float], ...] = (
        (450.0, 650.0), (800.0, 1050.0), (1500.0, 1800.0),
        (2350.0, 2550.0), (3150.0, 3350.0),
    )
    k_subframes: int = 2
    band_rise_db: float = 6.0
    excess_rise_db: float = 3.0
    min_Ehpf: float = 1e-10
    min_Eband: float = 1e-12
    use_dE_over_Ehpf: bool = False
    dE_over_Ehpf_thr: float = 0.08
    use_D_trigger: bool = False
    D_db: float = 6.0


@dataclass(frozen=True)
class BandNoiseEstimatorConfig:
    """The estimator's settings (``band_noise.py:78-144``); float32 on the
    device."""

    fs: int = 11162
    frame_len: int = 512
    hp_cutoff_hz: float = 350.0
    hp_order: int = 4
    band_hz: Tuple[float, float] = (400.0, 700.0)
    bpf_order: int = 4
    subframe_len: int = 128
    subhop: int = 128
    W: int = 30
    W_min: int = 10
    noise_buffer_ttl_frames: int = 200
    q: float = 0.3
    ema_alpha: float = 1.0
    beta: float = 1.0
    gain_floor: float = 0.10
    eps: float = 1e-12
    ne_attack_alpha_dry: float = 0.15
    ne_attack_alpha_wet: float = 0.02
    ne_release_alpha: float = 0.25
    smooth_N_E: bool = False
    learn_during_rain: bool = False
    force_learn_all: bool = False
    noise_replenish_from_all_subframes: bool = False
    noise_replenish_q: float = 0.20
    noise_replenish_only_when_buffer_not_full: bool = True
    noise_q_adapt_enable: bool = True
    noise_q_replenish_alpha: float = 0.2
    noise_q_normal_alpha: float = 0.1
    det: NoiseFrameDetectorConfig = field(default_factory=NoiseFrameDetectorConfig)

    def validate(self) -> None:
        if int(self.det.n_fft) != int(self.frame_len):
            raise ValueError(
                "det.n_fft must match frame_len so FFT diagnostics and FFT "
                "rain detection use the same spectrum"
            )
        if self.frame_len % self.subframe_len != 0:
            raise ValueError("subframe_len must divide frame_len")
        if not (0.0 < self.q < 1.0):
            raise ValueError("q must be in (0,1)")
        if not (0.0 < self.noise_replenish_q < 1.0):
            raise ValueError("noise_replenish_q must be in (0,1)")
        if not (0.0 < self.noise_q_replenish_alpha <= 1.0):
            raise ValueError("noise_q_replenish_alpha must be in (0,1]")
        if not (0.0 < self.noise_q_normal_alpha <= 1.0):
            raise ValueError("noise_q_normal_alpha must be in (0,1]")
        if self.W <= 0 or self.W_min < 0 or self.W_min > self.W:
            raise ValueError("Need W>0 and 0<=W_min<=W")
        if self.noise_buffer_ttl_frames < 0:
            raise ValueError("noise_buffer_ttl_frames must be >= 0")
        lo, hi = self.band_hz
        if not (0 < lo < hi < 0.5 * self.fs):
            raise ValueError("band_hz out of range")
        if not (0.0 < self.ema_alpha <= 1.0):
            raise ValueError("ema_alpha must be in (0, 1]")
        if not (isinstance(self.subhop, int) and self.subhop > 0):
            raise ValueError("subhop must be a positive integer")
        if self.frame_len < self.subframe_len:
            raise ValueError("frame_len must be >= subframe_len")
        if (self.frame_len - self.subframe_len) % self.subhop != 0:
            raise ValueError(
                "(frame_len - subframe_len) must be divisible by subhop"
            )


#: output field order of the per-frame telemetry (``band_noise.py:148-158``)
FRAME_OUT_FIELDS = (
    "M_band", "E_band", "N_E", "N_E_raw", "G_mag", "M_clean",
    "fft_rain_frame", "M_band_fft", "E_band_fft", "E_hpf",
    "rain_submask", "subE", "N_sub",
    "noise_energy_sum", "rain_energy_sum", "total_energy_sum",
    "noise_frame_count", "rain_frame_count", "total_frame_count",
    "noise_buffer_valid_count", "noise_buffer_min_valid_count",
    "noise_buffer_underflow_frame_count", "frames_since_noise_update",
    "noise_learned_subframe_count", "noise_replenish_count",
    "noise_effective_q",
)


def n_subframes(cfg: BandNoiseEstimatorConfig) -> int:
    return 1 + (cfg.frame_len - cfg.subframe_len) // cfg.subhop


@functools.lru_cache(maxsize=32)
def _design_filters(cfg: BandNoiseEstimatorConfig):
    """The high-pass (None when ``hp_cutoff_hz <= 0``) and band-pass designs
    (``band_noise.py:161-173``)."""
    nyq = 0.5 * cfg.fs
    hpf = None
    if cfg.hp_cutoff_hz > 0:
        w = float(np.clip(cfg.hp_cutoff_hz / nyq, 1e-6, 0.999))
        hpf = butter_sos(cfg.hp_order, w, "highpass")
    lo, hi = cfg.band_hz
    w1 = float(np.clip(lo / nyq, 1e-6, 0.999))
    w2 = float(np.clip(hi / nyq, 1e-6, 0.999))
    if w2 <= w1:
        w2 = min(0.999, w1 + 1e-3)
    bpf = butter_sos(cfg.bpf_order, [w1, w2], "bandpass")
    return hpf, bpf


# ---------------------------------------------------------------------------
# Per-frame inputs of the scan
# ---------------------------------------------------------------------------


class _Columns(NamedTuple):
    sub_idx: np.ndarray   # (S, subframe_len) sample indices of the subframes
    band: np.ndarray      # FFT bins inside band_hz
    rain: np.ndarray      # the rain bands' bins, concatenated
    primary: np.ndarray   # the primary band's bins


@functools.lru_cache(maxsize=32)
def _columns(cfg: BandNoiseEstimatorConfig) -> _Columns:
    """Index sets of ``band_noise.py:220-257``."""
    N, det = cfg.frame_len, cfg.det
    S = n_subframes(cfg)
    sub_idx = np.arange(S)[:, None] * cfg.subhop + np.arange(cfg.subframe_len)[None, :]
    freqs = np.fft.rfftfreq(N, d=1.0 / cfg.fs)
    lo, hi = cfg.band_hz
    n_bins = det.n_fft // 2 + 1

    def band_cols(b0, b1):
        b0 = max(0, min(b0, n_bins - 1))
        b1 = max(0, min(b1, n_bins - 1))
        if b1 < b0:
            return np.zeros(0, np.int64)
        return np.arange(b0, b1 + 1)

    rain = np.concatenate([
        band_cols(hz_to_bin(f0, det.fs, det.n_fft), hz_to_bin(f1, det.fs, det.n_fft))
        for f0, f1 in det.rain_bands_hz
    ])
    primary = band_cols(hz_to_bin(det.primary_hz[0], det.fs, det.n_fft),
                        hz_to_bin(det.primary_hz[1], det.fs, det.n_fft))
    return _Columns(sub_idx, np.flatnonzero((freqs >= lo) & (freqs <= hi)), rain, primary)


def _per_frame_inputs(x_h: torch.Tensor, x_bp: torch.Tensor, cfg: BandNoiseEstimatorConfig,
                      T: int):
    """Per-frame quantities of B streams (``band_noise.py:212-260``):
    ``(subE, subEhpf, rain_sum, primary, Eb, Mb, Mb_fft, Eb_fft, E_hpf)``,
    (B, T, S) for the first two and (B, T) for the rest.  Every sum is a
    :func:`tree_sum`, and the frame power is the unwindowed rFFT of the
    high-passed frames (K1 on the card), so a frame's values do not depend on
    the call it is in."""
    B = x_h.shape[0]
    N = cfg.frame_len
    cols = _columns(cfg)
    dev = x_h.device
    frames_h = x_h.reshape(B, T, N)
    frames_bp = x_bp.reshape(B, T, N)
    sub_idx = torch.as_tensor(cols.sub_idx, device=dev)
    E_hpf = tree_sum(frames_h * frames_h)
    subs_h = frames_h[..., sub_idx]  # (B, T, S, subframe_len)
    subEhpf = tree_sum(subs_h * subs_h)
    subs_b = frames_bp[..., sub_idx]
    subE = tree_sum(subs_b * subs_b)

    P = spectrogram_power(x_h, n_fft=cfg.det.n_fft, hop=N, center=False, window="rect")
    mag = torch.sqrt(P)  # (B, F, T)

    def bins_sum(Z, idx):
        return tree_sum(Z[:, torch.as_tensor(idx, device=dev), :], dim=1)

    Mb_fft = bins_sum(mag, cols.band)
    Eb_fft = bins_sum(P, cols.band)
    Eb = tree_sum(frames_bp * frames_bp)
    Mb = torch.sqrt(torch.clamp(Eb, min=0.0))
    return (subE, subEhpf, bins_sum(P, cols.rain), bins_sum(P, cols.primary), Eb, Mb,
            Mb_fft, Eb_fft, E_hpf)


# ---------------------------------------------------------------------------
# The scan carry and the state
# ---------------------------------------------------------------------------

#: float32 scalars of the carry, in K6's order
_CARRY_F = ("prev_rain_sum", "prev_primary", "prev_Eb", "prev_Lb", "prev_Lh", "noise_ema",
            "noise_effective_q", "N_E_smooth", "noise_energy_sum", "rain_energy_sum",
            "total_energy_sum")
#: bool and int32 scalars of the carry, in K6's order
_CARRY_I = ("have_prev_fft", "have_prev_Eb", "have_prev_L", "hold", "wr", "count_valid",
            "frames_since_noise_update", "frame_idx", "noise_frame_count", "rain_frame_count",
            "total_frame_count", "min_valid_count", "underflow_count", "learned_total",
            "replenish_total")
_CARRY_BOOL = ("have_prev_fft", "have_prev_Eb", "have_prev_L")
#: K6's float and int outputs, in its order
_OUT_F = ("N_E", "N_E_raw", "G_mag", "M_clean", "N_sub", "noise_energy_sum", "rain_energy_sum",
          "total_energy_sum", "noise_effective_q")
_OUT_I = ("fft_rain_frame", "noise_frame_count", "rain_frame_count", "total_frame_count",
          "noise_buffer_valid_count", "noise_buffer_min_valid_count",
          "noise_buffer_underflow_frame_count", "frames_since_noise_update",
          "noise_learned_subframe_count", "noise_replenish_count")


def _scan_carry_init(cfg: BandNoiseEstimatorConfig, n_streams: int,
                     device: str | torch.device) -> Dict[str, torch.Tensor]:
    """The estimator scan's initial carry for ``n_streams`` streams
    (``band_noise.py:327-355``): (B,) scalars and (B, W) ring buffers."""
    B, W, dev = int(n_streams), int(cfg.W), torch.device(device)
    c: Dict[str, torch.Tensor] = {}
    for k in _CARRY_F:
        c[k] = torch.zeros(B, dtype=torch.float32, device=dev)
    c["noise_effective_q"].fill_(float(np.float32(cfg.q)))
    for k in _CARRY_I:
        c[k] = torch.zeros(B, dtype=torch.bool if k in _CARRY_BOOL else torch.int32, device=dev)
    c["buf"] = torch.zeros((B, W), dtype=torch.float32, device=dev)
    c["valid"] = torch.zeros((B, W), dtype=torch.bool, device=dev)
    c["buf_frame_idx"] = torch.full((B, W), -1, dtype=torch.int32, device=dev)
    return c


def band_noise_init_state(cfg: BandNoiseEstimatorConfig, n_streams: int = 1,
                          device: str | torch.device = "cuda") -> State:
    """Fresh state of ``n_streams`` streams (``band_noise.py:263-272``):
    filters unseeded, the scan carry at its start."""
    hpf, bpf = _design_filters(cfg)
    n_h = hpf.shape[0] if hpf is not None else 0
    B, dev = int(n_streams), torch.device(device)
    return {
        "seeded": torch.zeros(B, dtype=torch.bool, device=dev),
        "zi_h": torch.zeros((B, n_h, 2), dtype=torch.float32, device=dev),
        "zi_b": torch.zeros((B, bpf.shape[0], 2), dtype=torch.float32, device=dev),
        "scan": _scan_carry_init(cfg, B, dev),
    }


_RESET_KEYS = ("buf", "valid", "buf_frame_idx", "wr", "count_valid",
               "frames_since_noise_update", "noise_ema", "noise_effective_q", "N_E_smooth")


def band_noise_reset_noise_estimator(cfg: BandNoiseEstimatorConfig, state: State) -> State:
    """Mid-stream noise-estimator reset (``band_noise.py:275-289``): clears
    the ring buffer, EMA, effective q and N_E smoothing, keeps the filter and
    detector state and the frame index (the TTL's timebase)."""
    scan = dict(state["scan"])
    fresh = _scan_carry_init(cfg, scan["wr"].shape[0], scan["wr"].device)
    for k in _RESET_KEYS:
        scan[k] = fresh[k]
    return {**state, "scan": scan}


# ---------------------------------------------------------------------------
# K6: the estimator scan
# ---------------------------------------------------------------------------


class _ScanConsts(NamedTuple):
    """What the scan step reads from the configuration, as Python numbers
    (float32 once on the device, as the JAX program rounds them)."""

    S: int
    W: int
    M_ratio: float
    N_ratio: float
    D_ratio: float
    hold_k: int
    ttl: int
    learn_all: bool
    replenish: bool
    rq_lo: int
    rq_hi: int
    rq_frac: float


def _scan_consts(cfg: BandNoiseEstimatorConfig, S: int) -> _ScanConsts:
    det = cfg.det
    h = np.float32(cfg.noise_replenish_q) * np.float32(S - 1)  # quantile_linear's position
    lo, hi = int(np.floor(h)), int(np.ceil(h))
    return _ScanConsts(
        S=S, W=int(cfg.W), M_ratio=db_to_ratio(det.M_db), N_ratio=db_to_ratio(det.N_db),
        D_ratio=db_to_ratio(det.D_db), hold_k=max(0, int(det.k_subframes) - 1),
        ttl=int(cfg.noise_buffer_ttl_frames),
        learn_all=bool(cfg.force_learn_all or cfg.learn_during_rain),
        replenish=bool(cfg.noise_replenish_from_all_subframes), rq_lo=lo, rq_hi=hi,
        rq_frac=float(h - np.float32(lo)))


def _band_scan_plain(cfg: BandNoiseEstimatorConfig, carry: Dict[str, torch.Tensor], inputs):
    """K6's plain loop: the step of ``band_noise.py:431-618`` over the frames
    of B lanes, operation for operation as the kernel does it.  Sums over
    subframes run left to right; the ring buffer takes a frame's pushes one
    after another (the JAX one-hot push writes the same slots, which are
    distinct while S <= W).  Returns ``(outs, carry)`` with K6's outputs."""
    subE, subEhpf, rain_sum, primary, Eb, Mb = inputs[:6]
    det = cfg.det
    B, T, S = subE.shape
    k = _scan_consts(cfg, S)
    W = k.W
    dev = subE.device
    c = {key: v.clone() for key, v in carry.items()}
    slots = torch.arange(W, device=dev)
    lane = torch.arange(B, device=dev)
    outs = {key: [] for key in (*_OUT_F, *_OUT_I, "rain_submask")}

    def push(v, do):
        j = c["wr"].long()
        hit = (slots[None, :] == j[:, None]) & do[:, None]
        was_valid = c["valid"][lane, j]
        c["buf"] = torch.where(hit, v[:, None], c["buf"])
        c["valid"] = c["valid"] | hit
        c["buf_frame_idx"] = torch.where(hit, c["frame_idx"][:, None], c["buf_frame_idx"])
        c["count_valid"] = c["count_valid"] + (do & ~was_valid).to(torch.int32)
        c["wr"] = torch.where(do, (c["wr"] + 1) % W, c["wr"])

    for t in range(T):
        sE, sEh = subE[:, t], subEhpf[:, t]
        c["frame_idx"] = c["frame_idx"] + 1

        # ---- FFT rain decision ----
        cond1 = rain_sum[:, t] > (c["prev_rain_sum"] + EPS) * k.M_ratio
        cond2 = primary[:, t] > (c["prev_primary"] + EPS) * k.N_ratio
        fft_rain = c["have_prev_fft"] & cond1 & cond2
        c["prev_rain_sum"], c["prev_primary"] = rain_sum[:, t], primary[:, t]
        c["have_prev_fft"] = torch.ones_like(fft_rain)

        # ---- time-domain mask over the subframes ----
        mask = []
        for s in range(S):
            Eb_s = torch.clamp(sE[:, s], min=EPS)
            m = c["hold"] > 0
            c["hold"] = torch.where(m, c["hold"] - 1, c["hold"])
            Eh_s = sEh[:, s]
            ok = (Eh_s >= det.min_Ehpf) & (Eb_s >= det.min_Eband)
            Lb = 10.0 * torch.log10(Eb_s + EPS)
            Lh = 10.0 * torch.log10(Eh_s + EPS)
            dLb = Lb - c["prev_Lb"]
            dLh = Lh - c["prev_Lh"]
            trig = ok & c["have_prev_L"] & (dLb >= det.band_rise_db) & (
                (dLb - dLh) >= det.excess_rise_db)
            c["prev_Lb"] = torch.where(ok, Lb, c["prev_Lb"])
            c["prev_Lh"] = torch.where(ok, Lh, c["prev_Lh"])
            c["have_prev_L"] = ok
            if det.use_dE_over_Ehpf:
                dE = torch.clamp(Eb_s - c["prev_Eb"], min=0.0)
                metric = dE / (torch.clamp(Eh_s, min=EPS) + EPS)
                trig = trig | (c["have_prev_Eb"] & (metric >= det.dE_over_Ehpf_thr))
            if det.use_D_trigger:
                trig = trig | (c["have_prev_Eb"] & (Eb_s > (c["prev_Eb"] + EPS) * k.D_ratio))
            m = m | trig
            c["hold"] = torch.where(trig, torch.clamp(c["hold"], min=k.hold_k), c["hold"])
            c["prev_Eb"] = Eb_s
            c["have_prev_Eb"] = torch.ones_like(ok)
            mask.append(m)
        sub = torch.stack(mask, dim=-1) | fft_rain[:, None]  # (B, S)

        # ---- expiry before learning ----
        if k.ttl > 0:
            stale = c["valid"] & ((c["frame_idx"][:, None] - c["buf_frame_idx"]) > k.ttl)
            do = c["count_valid"] > 0
            n_stale = stale.sum(dim=-1).to(torch.int32)
            gone = do[:, None] & stale
            c["valid"] = c["valid"] & ~gone
            c["buf"] = torch.where(gone, 0.0, c["buf"])
            c["buf_frame_idx"] = torch.where(gone, -1, c["buf_frame_idx"])
            c["count_valid"] = torch.where(do, torch.clamp(c["count_valid"] - n_stale, min=0),
                                           c["count_valid"])

        # ---- learning ----
        learn = torch.ones_like(sub) if k.learn_all else ~sub
        vals = torch.clamp(sE, min=float(cfg.eps))
        for s in range(S):
            push(vals[:, s], learn[:, s])
        learned = learn.sum(dim=-1).to(torch.int32)
        replenish = torch.zeros_like(learned)
        if k.replenish:
            should = learned == 0
            if cfg.noise_replenish_only_when_buffer_not_full:
                should = should & (c["count_valid"] < W)
            q_noise = quantile_linear(sE, cfg.noise_replenish_q)
            push(torch.clamp(q_noise, min=float(cfg.eps)), should)
            replenish = should.to(torch.int32)
        c["learned_total"] = c["learned_total"] + learned
        c["replenish_total"] = c["replenish_total"] + replenish
        c["frames_since_noise_update"] = torch.where(
            (learned + replenish) > 0, 0, c["frames_since_noise_update"] + 1)

        # ---- adaptive q ----
        if cfg.noise_q_adapt_enable:
            q_eff = c["noise_effective_q"]
            ra, na = cfg.noise_q_replenish_alpha, cfg.noise_q_normal_alpha
            q_eff = torch.where(replenish > 0,
                                q_eff * (1.0 - ra) + ra * cfg.noise_replenish_q, q_eff)
            q_eff = torch.where(learned > 0, q_eff * (1.0 - na) + na * cfg.q, q_eff)
            c["noise_effective_q"] = torch.clamp(q_eff, 1e-6, 1.0 - 1e-6)

        # ---- noise scalar (warm-up semantics) ----
        warm = c["count_valid"] >= cfg.W_min
        qv = masked_quantile_rankselect(c["buf"], c["valid"], c["noise_effective_q"])
        a = float(cfg.ema_alpha)
        ema_new = (1.0 - a) * c["noise_ema"] + a * qv
        c["noise_ema"] = torch.where(warm, ema_new, 0.0)
        c["N_E_smooth"] = torch.where(warm, c["N_E_smooth"], 0.0)
        N_sub = torch.where(warm, c["noise_ema"], 0.0)
        N_E_raw = float(S) * N_sub
        any_rain = sub.any(dim=-1)
        if cfg.smooth_N_E:
            up = torch.where(any_rain, cfg.ne_attack_alpha_wet, cfg.ne_attack_alpha_dry)
            alpha = torch.where(N_E_raw > c["N_E_smooth"], up, cfg.ne_release_alpha)
            c["N_E_smooth"] = (1.0 - alpha) * c["N_E_smooth"] + alpha * N_E_raw
            N_E = c["N_E_smooth"]
        else:
            N_E = N_E_raw

        # ---- telemetry ----
        rain_e = torch.where(sub[:, 0], sE[:, 0], 0.0)
        dry_e = torch.where(sub[:, 0], 0.0, sE[:, 0])
        for s in range(1, S):
            rain_e = rain_e + torch.where(sub[:, s], sE[:, s], 0.0)
            dry_e = dry_e + torch.where(sub[:, s], 0.0, sE[:, s])
        noise_e = torch.minimum(torch.clamp(N_E, min=0.0), torch.clamp(dry_e, min=0.0))
        prev_total = c["total_frame_count"]
        c["total_energy_sum"] = c["total_energy_sum"] + torch.clamp(Eb[:, t], min=0.0)
        c["rain_energy_sum"] = c["rain_energy_sum"] + rain_e
        c["noise_energy_sum"] = c["noise_energy_sum"] + noise_e
        c["total_frame_count"] = prev_total + 1
        c["min_valid_count"] = torch.where(prev_total == 0, c["count_valid"],
                                           torch.minimum(c["min_valid_count"], c["count_valid"]))
        c["underflow_count"] = c["underflow_count"] + (c["count_valid"] < cfg.W_min).to(torch.int32)
        c["rain_frame_count"] = c["rain_frame_count"] + any_rain.to(torch.int32)
        c["noise_frame_count"] = c["noise_frame_count"] + (~any_rain).to(torch.int32)

        # ---- Wiener gain ----
        num = torch.clamp(Eb[:, t] - cfg.beta * N_E, min=0.0)
        G_pow = num / (Eb[:, t] + float(cfg.eps))
        G_mag = torch.clamp(torch.sqrt(torch.clamp(G_pow, 0.0, 1.0)), cfg.gain_floor, 1.0)

        step = {
            "N_E": N_E, "N_E_raw": N_E_raw, "G_mag": G_mag, "M_clean": Mb[:, t] * G_mag,
            "N_sub": N_sub, "noise_energy_sum": c["noise_energy_sum"],
            "rain_energy_sum": c["rain_energy_sum"], "total_energy_sum": c["total_energy_sum"],
            "noise_effective_q": c["noise_effective_q"], "fft_rain_frame": fft_rain,
            "noise_frame_count": c["noise_frame_count"], "rain_frame_count": c["rain_frame_count"],
            "total_frame_count": c["total_frame_count"],
            "noise_buffer_valid_count": c["count_valid"],
            "noise_buffer_min_valid_count": c["min_valid_count"],
            "noise_buffer_underflow_frame_count": c["underflow_count"],
            "frames_since_noise_update": c["frames_since_noise_update"],
            "noise_learned_subframe_count": c["learned_total"],
            "noise_replenish_count": c["replenish_total"], "rain_submask": sub,
        }
        for key, v in step.items():
            outs[key].append(v)
    return {key: torch.stack(v, dim=1) for key, v in outs.items()}, c


#: lanes K6 takes in its ring buffer and subframes
K6_MAX_W = 64
K6_MAX_S = 8


class _BandConsts(ctypes.Structure):
    """``BandConsts`` of ``csrc/band_noise.cu``, field for field."""

    _f, _i = ctypes.c_float, ctypes.c_int
    _fields_ = [
        ("M_ratio", _f), ("N_ratio", _f), ("D_ratio", _f), ("eps12", _f), ("min_Ehpf", _f),
        ("min_Eband", _f), ("band_rise_db", _f), ("excess_rise_db", _f), ("dE_thr", _f),
        ("hold_k", _i), ("use_dE", _i), ("use_D", _i), ("ttl", _i), ("W", _i), ("W_min", _i),
        ("learn_all", _i), ("replenish", _i), ("replenish_not_full", _i), ("rq_lo", _i),
        ("rq_hi", _i), ("rq_frac", _f), ("eps", _f), ("q_adapt", _i), ("ra_keep", _f),
        ("ra_add", _f), ("na_keep", _f), ("na_add", _f), ("q_min", _f), ("q_max", _f),
        ("ema_keep", _f), ("ema_a", _f), ("S_f", _f), ("smooth", _i), ("wet", _f), ("dry", _f),
        ("release", _f), ("beta", _f), ("gain_floor", _f), ("S", _i), ("B", _i), ("T", _i),
    ]


class _BandIO(ctypes.Structure):
    """``BandIO`` of ``csrc/band_noise.cu``, field for field."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "subE", "subEhpf", "rain_sum", "primary", "Eb", "Mb",
        "cf", "ci", "buf", "valid", "bidx", "o_cf", "o_ci", "o_buf", "o_valid", "o_bidx",
        "of", "oi", "om")]


def _band_consts(cfg: BandNoiseEstimatorConfig, B: int, T: int, S: int) -> _BandConsts:
    det, k = cfg.det, _scan_consts(cfg, S)
    ra, na, a = cfg.noise_q_replenish_alpha, cfg.noise_q_normal_alpha, float(cfg.ema_alpha)
    return _BandConsts(
        M_ratio=k.M_ratio, N_ratio=k.N_ratio, D_ratio=k.D_ratio, eps12=EPS,
        min_Ehpf=det.min_Ehpf, min_Eband=det.min_Eband, band_rise_db=det.band_rise_db,
        excess_rise_db=det.excess_rise_db, dE_thr=det.dE_over_Ehpf_thr, hold_k=k.hold_k,
        use_dE=int(det.use_dE_over_Ehpf), use_D=int(det.use_D_trigger), ttl=k.ttl, W=k.W,
        W_min=int(cfg.W_min), learn_all=int(k.learn_all), replenish=int(k.replenish),
        replenish_not_full=int(cfg.noise_replenish_only_when_buffer_not_full),
        rq_lo=k.rq_lo, rq_hi=k.rq_hi, rq_frac=k.rq_frac, eps=float(cfg.eps),
        q_adapt=int(cfg.noise_q_adapt_enable), ra_keep=1.0 - ra,
        ra_add=ra * cfg.noise_replenish_q, na_keep=1.0 - na, na_add=na * cfg.q,
        q_min=1e-6, q_max=1.0 - 1e-6, ema_keep=1.0 - a, ema_a=a, S_f=float(S),
        smooth=int(cfg.smooth_N_E), wet=cfg.ne_attack_alpha_wet, dry=cfg.ne_attack_alpha_dry,
        release=cfg.ne_release_alpha, beta=cfg.beta, gain_floor=cfg.gain_floor, S=S, B=B, T=T)


def _band_scan_cuda(cfg: BandNoiseEstimatorConfig, carry: Dict[str, torch.Tensor], inputs):
    """K6 on the card; returns what :func:`_band_scan_plain` returns."""
    subE, subEhpf, rain_sum, primary, Eb, Mb = (t.contiguous() for t in inputs[:6])
    B, T, S = subE.shape
    W = int(cfg.W)
    dev = subE.device
    for name, t, ndim in (("subE", subE, 3), ("subEhpf", subEhpf, 3), ("rain_sum", rain_sum, 2),
                          ("primary", primary, 2), ("Eb", Eb, 2), ("Mb", Mb, 2)):
        _kernels.require_cuda(f"band_noise_scan({name})", t, torch.float32, ndim)
        if t.shape[:2] != (B, T):
            raise ValueError(f"band_noise_scan: {name} of shape {tuple(t.shape)} does not fit "
                             f"{B} x {T} frames")
    if subEhpf.shape != subE.shape:
        raise ValueError("band_noise_scan: subE and subEhpf differ in shape")
    if not (1 <= S <= K6_MAX_S and S <= W <= K6_MAX_W):
        raise ValueError(f"band_noise_scan: the CUDA kernel takes 1 <= S <= {K6_MAX_S} "
                         f"subframes and S <= W <= {K6_MAX_W} slots; got S={S}, W={W}")
    # the bool tensors (the valid flags, the sub mask) go in and out as their
    # bytes, so that they need no conversion
    name = "band_noise_scan(carry)"
    cf = torch.stack([_kernels.carry_vector(name, carry[k], subE, B, torch.float32)
                      for k in _CARRY_F], dim=1).contiguous()
    ci = torch.stack([_kernels.carry_vector(name, carry[k], subE, B, torch.int32)
                      for k in _CARRY_I], dim=1).contiguous()
    buf = _kernels.carry_vector(name, carry["buf"], subE, B * W, torch.float32)
    valid = _kernels.carry_vector(name, carry["valid"], subE, B * W, torch.bool)
    bidx = _kernels.carry_vector(name, carry["buf_frame_idx"], subE, B * W, torch.int32)
    o_cf, o_ci = torch.empty_like(cf), torch.empty_like(ci)
    o_buf, o_valid, o_bidx = torch.empty_like(buf), torch.empty_like(valid), torch.empty_like(bidx)
    of = torch.empty((len(_OUT_F), B, T), dtype=torch.float32, device=dev)
    oi = torch.empty((len(_OUT_I), B, T), dtype=torch.int32, device=dev)
    om = torch.empty((B, T, S), dtype=torch.bool, device=dev)  # the kernel writes 0 and 1 bytes
    io = _BandIO(*(t.data_ptr() for t in (subE, subEhpf, rain_sum, primary, Eb, Mb, cf, ci, buf,
                                          valid, bidx, o_cf, o_ci, o_buf, o_valid, o_bidx, of,
                                          oi, om)))
    consts = _band_consts(cfg, B, T, S)
    lib = _kernels.build()
    with torch.cuda.device(dev):
        err = lib.lib.apt_band_noise_scan(ctypes.addressof(io), ctypes.addressof(consts),
                                          _kernels.stream_of(subE))
    lib.check(err, "band_noise_scan")
    _kernels.count("band_noise_scan")
    out = {key: of[i] for i, key in enumerate(_OUT_F)}
    out.update({key: oi[i] for i, key in enumerate(_OUT_I)})
    out["fft_rain_frame"] = out["fft_rain_frame"].bool()
    out["rain_submask"] = om
    new = {key: o_cf[:, i] for i, key in enumerate(_CARRY_F)}
    flags = o_ci[:, : len(_CARRY_BOOL)].bool()  # _CARRY_I begins with the bool scalars
    new.update({key: (flags[:, i] if key in _CARRY_BOOL else o_ci[:, i])
                for i, key in enumerate(_CARRY_I)})
    new["buf"] = o_buf.reshape(B, W)
    new["valid"] = o_valid.reshape(B, W)
    new["buf_frame_idx"] = o_bidx.reshape(B, W)
    return out, new


def _run_band_scan(cfg: BandNoiseEstimatorConfig, carry: Dict[str, torch.Tensor], inputs):
    """The estimator scan over per-frame inputs of B lanes
    (``band_noise.py:358-624``): K6 on a CUDA tensor, its plain loop on a
    CPU tensor.  Returns ``(outs, carry)``: the 26 ``FRAME_OUT_FIELDS``,
    (B, T) or (B, T, S), and the carry after the last frame."""
    if inputs[0].device.type == "cpu":
        out, carry = _band_scan_plain(cfg, carry, inputs)
    else:
        out, carry = _band_scan_cuda(cfg, carry, inputs)
    subE, _, _, _, Eb, Mb, Mb_fft, Eb_fft, E_hpf = inputs
    S = subE.shape[-1]
    out.update(M_band=Mb, E_band=Eb, M_band_fft=Mb_fft, E_band_fft=Eb_fft, E_hpf=E_hpf, subE=subE,
               N_sub=out["N_sub"][..., None].expand(out["N_sub"].shape + (S,)).contiguous())
    return {k: out[k] for k in FRAME_OUT_FIELDS}, carry


# ---------------------------------------------------------------------------
# Whole clips and chunks
# ---------------------------------------------------------------------------


def _as_frames(x, cfg: BandNoiseEstimatorConfig, device=None) -> Tuple[torch.Tensor, bool]:
    """``x`` as float32 (B, T frame_len), whole frames only, and whether it
    was one 1-D stream."""
    x = torch.as_tensor(x, device=device).to(torch.float32)
    single = x.dim() == 1
    if single:
        x = x[None]
    if x.dim() != 2:
        raise ValueError(f"expected a (N,) stream or (B, N) streams; got shape {tuple(x.shape)}")
    N = cfg.frame_len
    if x.shape[-1] < N:
        raise ValueError(f"need at least one frame of {N} samples; got {x.shape[-1]}")
    return x[:, : x.shape[-1] // N * N], single


def _filters(cfg: BandNoiseEstimatorConfig, x: torch.Tensor, zi_h, zi_b):
    """The high-pass then the band-pass over ``x`` (B, T N) from their
    states, and their final states."""
    hpf, bpf = _design_filters(cfg)
    if hpf is not None:
        x_h, zf_h = cascade_sosfilt(hpf, x, zi_h)
    else:
        x_h, zf_h = x, zi_h
    x_bp, zf_b = cascade_sosfilt(bpf, x_h, zi_b)
    return x_h, x_bp, zf_h, zf_b


def _seed(sos: Optional[np.ndarray], x0: torch.Tensor) -> torch.Tensor:
    """``sosfilt_zi(sos)`` in float32 times each stream's first sample,
    (B, S, 2): the JAX product ``jnp.asarray(sosfilt_zi, float32) * x0``."""
    if sos is None:
        return x0.new_zeros((x0.shape[0], 0, 2))
    zi = device_constant(("sosfilt_zi", sos.tobytes()), x0.device, lambda: sosfilt_zi(sos))
    return zi[None] * x0[:, None, None]


def band_noise_process(x, cfg: BandNoiseEstimatorConfig,
                       device: str | torch.device = "cuda") -> Dict[str, torch.Tensor]:
    """Whole clips through the streaming estimator (``band_noise.py:176-209``)
    on ``device``: (N,) or (B, N) samples (NumPy or a tensor), frames contiguous
    (``hop == frame_len``), at least one frame (JAX raises an IndexError on
    less; this raises ``ValueError``).  Both filters start from the raw first
    sample.
    Returns the ``FRAME_OUT_FIELDS``, (B, T) or (B, T, S), without the
    stream axis for a 1-D ``x``."""
    x, single = _as_frames(x, cfg, torch.device(device))
    hpf, bpf = _design_filters(cfg)
    x0 = x[:, 0]
    x_h, x_bp, _, _ = _filters(cfg, x, _seed(hpf, x0), _seed(bpf, x0))
    inputs = _per_frame_inputs(x_h, x_bp, cfg, x.shape[-1] // cfg.frame_len)
    out, _ = _run_band_scan(cfg, _scan_carry_init(cfg, x.shape[0], x.device), inputs)
    return sorted_keys({k: v[0] for k, v in out.items()} if single else out)


def band_noise_process_chunk(x, cfg: BandNoiseEstimatorConfig, state: State):
    """One chunk of B streams with carried state (``band_noise.py:292-324``):
    ``x`` (B, L) on the state's device, L a multiple of ``frame_len`` (the
    rest is dropped).  A stream not yet seeded starts both filters from its
    raw first sample.  Threading the state through chunks gives the bits of
    :func:`band_noise_process` over the whole stream.  Returns
    ``(outs, new_state)``, outs (B, T) or (B, T, S)."""
    x, _ = _as_frames(x, cfg, state["seeded"].device)
    B = x.shape[0]
    if state["seeded"].shape[0] != B:
        raise ValueError(f"{B} chunks for a state of {state['seeded'].shape[0]} streams")
    hpf, bpf = _design_filters(cfg)
    x0 = x[:, 0]
    seeded = state["seeded"][:, None, None]
    zi_h = torch.where(seeded, state["zi_h"], _seed(hpf, x0))
    zi_b = torch.where(seeded, state["zi_b"], _seed(bpf, x0))
    x_h, x_bp, zf_h, zf_b = _filters(cfg, x, zi_h, zi_b)
    inputs = _per_frame_inputs(x_h, x_bp, cfg, x.shape[-1] // cfg.frame_len)
    out, scan = _run_band_scan(cfg, state["scan"], inputs)
    new = {"seeded": torch.ones_like(state["seeded"]), "zi_h": zf_h, "zi_b": zf_b, "scan": scan}
    return sorted_keys(out), sorted_keys(new)


# ---------------------------------------------------------------------------
# State across frameworks and connections
# ---------------------------------------------------------------------------


def _map_state(state, fn):
    return {k: _map_state(v, fn) if isinstance(v, dict) else fn(v) for k, v in state.items()}


def state_from_jax(np_state: Dict[str, Any], device: str | torch.device = "cuda") -> State:
    """A JAX band-noise state (NumPy leaves, one stream from
    ``band_noise_init_state`` or a batch with a leading stream axis) as the
    port's state on ``device``, leaf for leaf: a stream begun in JAX goes on
    here."""
    single = np.ndim(np_state["seeded"]) == 0

    def conv(v):
        a = np.array(v)
        return torch.as_tensor(a[None] if single else a, device=torch.device(device))

    return _map_state(np_state, conv)


def state_to_jax(state: State, stream: Optional[int] = None) -> Dict[str, Any]:
    """The port's state as the JAX package's, NumPy leaves: the batched
    layout, or stream ``stream``'s single-stream layout."""
    return _map_state(state, lambda v: v.cpu().numpy() if stream is None
                      else v[stream].cpu().numpy())


def stack_states(states) -> State:
    """Per-stream states (each with its stream axis) as one batch."""
    first = states[0]
    return {k: stack_states([s[k] for s in states]) if isinstance(first[k], dict)
            else torch.cat([s[k] for s in states]) for k in first}


def split_state(state: State):
    """A batch state as per-stream states, each with a stream axis of 1."""
    B = state["seeded"].shape[0]
    return [_map_state(state, lambda v, i=i: v[i : i + 1]) for i in range(B)]


# ---------------------------------------------------------------------------
# Framework adapter (``band_noise.py:627-790``)
# ---------------------------------------------------------------------------


def build_band_noise_config(params: Dict[str, Any]) -> BandNoiseEstimatorConfig:
    """The estimator's config from framework params, with ``det.*`` dotted
    overrides (``band_noise.py:632-664``)."""
    p = dict(params)
    det_kwargs: Dict[str, Any] = dict(p.pop("det", {}) or {})
    for k in list(p.keys()):
        if k.startswith("det."):
            det_kwargs[k[4:]] = p.pop(k)

    fs = int(p.get("sample_rate", p.get("fs", 11162)))
    frame_len = int(p.get("frame_len", 512))
    det_kwargs.setdefault("fs", fs)
    det_kwargs.setdefault("n_fft", frame_len)
    det_fields = set(NoiseFrameDetectorConfig.__dataclass_fields__)
    det_kwargs = {k: v for k, v in det_kwargs.items() if k in det_fields}
    if "primary_hz" in det_kwargs:
        det_kwargs["primary_hz"] = tuple(det_kwargs["primary_hz"])
    if "rain_bands_hz" in det_kwargs:
        det_kwargs["rain_bands_hz"] = tuple(tuple(b) for b in det_kwargs["rain_bands_hz"])
    det = NoiseFrameDetectorConfig(**det_kwargs)

    est_fields = set(BandNoiseEstimatorConfig.__dataclass_fields__)
    est_kwargs = {k: v for k, v in p.items() if k in est_fields and k != "det"}
    est_kwargs["fs"] = fs
    est_kwargs["frame_len"] = frame_len
    if "band_hz" in est_kwargs:
        est_kwargs["band_hz"] = tuple(est_kwargs["band_hz"])
    cfg = BandNoiseEstimatorConfig(det=det, **est_kwargs)
    cfg.validate()
    return cfg


_TELEMETRY_KEYS = (
    "noise_energy_sum", "rain_energy_sum", "total_energy_sum",
    "noise_frame_count", "rain_frame_count", "total_frame_count",
    "noise_buffer_valid_count", "noise_buffer_min_valid_count",
    "noise_buffer_underflow_frame_count", "frames_since_noise_update",
    "noise_learned_subframe_count", "noise_replenish_count",
    "noise_effective_q",
)


def _summarize_frames(row: Dict[str, np.ndarray], name: str, mode: str,
                      latency: float) -> Dict[str, Any]:
    """Per-clip summary with the reference adapter's result keys plus the
    framework's extras (``band_noise.py:678-718``)."""
    T = int(row["E_band"].shape[0])

    def med(k):
        return float(np.median(row[k])) if T else float("nan")

    metrics: Dict[str, Any] = {
        "processor": name,
        "mode": mode,
        "n_frames": T,
        "M_clean_med": med("M_clean"),
        "noise_E_med": med("N_E"),
        "gain_med": med("G_mag"),
        "noise_effective_q_last": float(row["noise_effective_q"][-1]) if T else float("nan"),
        "noise_effective_q_med": med("noise_effective_q"),
        "fft_rain_frac": float(row["fft_rain_frame"].mean()) if T else float("nan"),
        "median_E_band": med("E_band"),
        "median_N_E": med("N_E"),
        "median_G_mag": med("G_mag"),
        "median_M_clean": med("M_clean"),
        "rain_submask_frac": float(row["rain_submask"].mean()) if T else 0.0,
        "latency_s": latency,
    }
    tele = {k: (float(row[k][-1]) if T else 0.0) for k in _TELEMETRY_KEYS}
    for kind in ("noise", "rain", "total"):
        tele[f"{kind}_energy_mean"] = tele[f"{kind}_energy_sum"] / max(
            1, int(tele[f"{kind}_frame_count"]))
    metrics.update({f"energy_stats__{k}": v for k, v in tele.items()})
    return metrics


def _check_hop(params: Dict[str, Any]) -> None:
    hop = int(params.get("hop", params.get("frame_len", 512)))
    frame_len = int(params.get("frame_len", 512))
    if hop != frame_len:
        raise ValueError(
            f"hop ({hop}) must equal frame_len ({frame_len}): the "
            "estimator streams IIR state across contiguous frames"
        )


class BandNoiseEstimatorProcessor:
    """Framework processor over the estimator (``band_noise.py:721-790``),
    on one device (the card unless the caller asks for the CPU).  Enforces
    ``hop == frame_len``; summary metrics are medians, detector fractions
    and the final telemetry."""

    def __init__(self, name: str = "band_noise", mode: str = "fft",
                 device: str | torch.device = "cuda"):
        self.name = name
        self.mode = mode  # kept for compatibility with result rows
        self.device = torch.device(device)

    def _outputs(self, audio, params) -> Tuple[Dict[str, np.ndarray], float]:
        _check_hop(params)
        cfg = build_band_noise_config(params)
        x = torch.as_tensor(audio).to(device=self.device, dtype=torch.float32)
        t0 = time.perf_counter()
        out = {k: v.cpu().numpy() for k, v in band_noise_process(x, cfg, self.device).items()}
        return out, time.perf_counter() - t0

    def run(self, audio_data, params: Dict[str, Any]) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        out, latency = self._outputs(torch.as_tensor(audio_data).reshape(-1), params)
        metrics = _summarize_frames(out, self.name, self.mode, latency)
        state: Dict[str, Any] = dict(out)
        state["processor"] = self.name
        state["latency_s"] = latency
        return metrics, state

    def run_batch(self, audio_matrix, params: Dict[str, Any]) -> list:
        """(B, N) clips in one batched call."""
        audio_matrix = torch.as_tensor(audio_matrix)
        if audio_matrix.dim() != 2:
            raise ValueError(f"expected (B, N) clips; got shape {tuple(audio_matrix.shape)}")
        B = audio_matrix.shape[0]
        out, latency = self._outputs(audio_matrix, params)
        latency /= max(B, 1)
        pairs = []
        for i in range(B):
            row = {k: v[i] for k, v in out.items()}
            state = dict(row)
            state["processor"] = self.name
            state["latency_s"] = latency
            pairs.append((_summarize_frames(row, self.name, self.mode, latency), state))
        return pairs
