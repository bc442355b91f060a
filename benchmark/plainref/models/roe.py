"""The reference of ``model="roe"``: the legacy "RoE" harmonic-novelty
rain classifier, plain PyTorch.

Frozen copy of the port's ``models/roe.py`` batch path on the CPU: every
2 s firmware chunk of every clip is one row; the order-8 operating
band-pass and the order-4 pulse band-pass run as the sequential-boundary
cascade from zero state, the magnitude is the square root of
``stft_power``, then the harmonic novelty, the spectral peaks, the pulse
features, the TD gate and the FP/FN combiner.  Only what the step's
per-clip outputs read is computed.  ``store`` is applied to each stage's
output tensor: the identity for the reference, a round trip through a
narrower type for the benchmark's control.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as tnf

from ..consts import f32, f32_recip
from ..filters import butter_sos, sosfilt
from ..framing import frame_signal
from ..peaks import local_maxima
from ..stats import tree_sum
from ..stft import stft_power


def _keep(t: torch.Tensor) -> torch.Tensor:
    return t


MAX_DURATION_FW = 2  # firmware chunk seconds (``dsp_rain_detection.py:2601``)


@dataclass(frozen=True)
class RoeConfig:
    """Parameter set of ``default_params`` (``roe.py:46-99``)."""

    sample_rate: int = 11162
    freq_resolution: int = 45
    time_resolution_ms: int = 10
    check_duration: float = 10
    op_freq_range: Tuple[float, float] = (400.0, 3500.0)
    n_freq_range: Tuple[float, float] = (400.0, 700.0)
    fn: float = 400.0
    num_harmonics: int = 6
    harmonic_threshold: Tuple[float, ...] = (4.5, 4.0, 3.5, 3.5, 3.5, 3.5)
    max_peaks: int = 3
    log_factor: float = 0.0
    ns_duration_ms: float = 470.0
    nf: float = 0.0
    min_drop_count: float = 0.3
    rain_drop_min_thr: float = 3
    rain_drop_max_thr: float = 50
    rain_peaks_min_thr: float = 9
    rain_peaks_max_thr: float = 30
    kurtosis_thr: float = 2.5
    crest_thr: float = 3.75
    diff_energy_thr: float = 6.5
    t_band: Tuple[float, float] = (400.0, 3500.0)
    handle_fp: bool = True
    handle_fn: bool = True

    @property
    def frame_length(self) -> int:
        return 2 ** math.ceil(math.log2(self.sample_rate / self.freq_resolution))

    @property
    def hop_length(self) -> int:
        return 2 ** math.ceil(math.log2(self.time_resolution_ms * self.sample_rate / 1000))

    @property
    def min_average_len(self) -> int:
        return math.ceil(
            ((self.ns_duration_ms * self.sample_rate / 1000) / self.hop_length - 1) / 2
        )

    @property
    def rain_thr_hn(self) -> float:
        t = self.harmonic_threshold
        return t[0] + t[1] + t[2]


#: settings whose other branches the reference leaves out, at the values it implements
_IMPLEMENTED = {"nf": 0.0, "log_factor": 0.0, "handle_fp": True, "handle_fn": True}


def build_roe_config(params: Dict[str, Any]) -> RoeConfig:
    """``RoeConfig`` from the step's parameters (unknown keys ignored, as
    the port does); raises for a setting the reference does not implement."""
    fields_ = set(RoeConfig.__dataclass_fields__)
    cfg = RoeConfig(**{k: tuple(v) if isinstance(v, list) else v
                       for k, v in params.items() if k in fields_})
    off = {k: getattr(cfg, k) for k, v in _IMPLEMENTED.items() if getattr(cfg, k) != v}
    if off:
        raise NotImplementedError(f"the RoE reference does not implement {off}")
    return cfg


def per_clip(params: Dict[str, Any], x: torch.Tensor,
             store: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
             ) -> Dict[str, torch.Tensor]:
    """The step's per-clip outputs of ``model="roe"`` for the clips ``x``
    (B, N)."""
    out = _roe_batch(x.to(torch.float32), build_roe_config(params), store or _keep)
    mod = out["rain_drop_count_mod"]
    return {"rain_drop_count_mod": mod, "rain_drop_count": out["rain_drop_count"],
            "rain_peaks_count": out["rain_peaks_count"], "frain_mean": out["frain_mean"],
            "clip_is_rain": mod > 0}


# ---------------------------------------------------------------------------
# novelty machinery
# ---------------------------------------------------------------------------


def _local_average_sorted3(x: torch.Tensor, M: int) -> torch.Tensor:
    """Mean of the smallest ``min(max(3, M // 6), 2M + 1)`` values in the
    +-M window of every position (``roe.py:119-161``; with M = 20 the 3
    smallest), windows padded with +inf; the order statistics come
    ascending from ``torch.topk`` and are summed left to right."""
    L = x.shape[-1]
    win_len = min(M // 6, L)
    win_len = max(win_len, 3)
    K = 2 * M + 1
    kk = min(win_len, K)
    w = tnf.pad(x, (M, M), value=math.inf).unfold(-1, K, 1)  # (..., L, K)
    s = torch.topk(w, kk, dim=-1, largest=False, sorted=True).values
    acc = s[..., 0]
    for r in range(1, kk):
        acc = acc + s[..., r]
    return acc * f32_recip(kk, x.device)


def _calculate_snr(nov: torch.Tensor, M: int) -> torch.Tensor:
    """(``roe.py:164-170``) over the last axis."""
    la = _local_average_sorted3(nov, M)
    fifth = torch.amax(nov, dim=-1, keepdim=True) * f32_recip(5.0, nov.device)
    la = torch.where(la <= 0, fifth, la)
    nov = torch.where(nov == 0, 1.0, nov)
    la = torch.where(la == 0, 1.0, la)
    return nov / la


def _novelty_spectrum(Y1: torch.Tensor, M: int, threshold: float) -> torch.Tensor:
    """(``roe.py:173-193``): ``Y1`` (..., F, T) band-masked magnitudes ->
    ``nov_t`` (..., T + 1): the positive first difference along frequency
    summed over frequency, SNR-normalized and peak-masked, thresholded and
    clipped at 1.5 x the threshold."""
    d = torch.clamp_min(Y1[..., 1:, :] - Y1[..., :-1, :], 0.0)
    nov = tree_sum(d, dim=-2)
    nov = tnf.pad(nov, (0, 1))
    nov = _calculate_snr(nov, M)
    mask = local_maxima(nov).to(nov.dtype)
    dev = nov.device
    nov_t = torch.where(nov > f32(threshold, dev),
                        torch.minimum(nov, f32(threshold * 1.5, dev)), 0.0)
    return nov_t * mask


def _band_mask_bins(f1: torch.Tensor, f2: torch.Tensor, Fs: float, N: int, F: int
                    ) -> torch.Tensor:
    """Rows kept by ``bp_filter_frequencies`` (``roe.py:196-203``): row in
    ``[floor(f1 / f_res) + 1, floor(f2 / f_res)]``, ``f_res = Fs / N``;
    ``f1``, ``f2`` float32 of shape (R,) or (), result (R, F) or (F,)."""
    inv_res = f32_recip(Fs / N, f1.device)
    idx1 = torch.floor(f1 * inv_res).to(torch.int64) + 1
    idx2 = torch.floor(f2 * inv_res).to(torch.int64)
    rows = torch.arange(F, device=f1.device)
    return (rows >= idx1[..., None]) & (rows <= idx2[..., None])


def _spectral_peaks(mag: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The local maxima along frequency of ``mag`` (R, F, T), as (R, T, F)
    booleans, and their running count along frequency (int32).  They do not
    depend on the search band, so one pair serves every harmonic's search
    (the JAX program computes them once too: XLA merges the six identical
    computations, ``roe.py:229-235``).  On the card K11 reads the
    transposed view in place and returns the mask in its layout."""
    is_max = local_maxima(mag.transpose(-1, -2))
    return is_max, torch.cumsum(is_max.to(torch.int32), dim=-1)


def _find_first_peak_in_range(mag: torch.Tensor, search_lo, search_hi, accept_lo,
                              accept_hi, Fs: float, num_peaks: int, peaks
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(``roe.py:206-245``) for ``mag`` (R, F, T) and bounds of shape (R,)
    or () (float32 tensors): among the first ``num_peaks`` spectral peaks
    (ascending bin) inside the search range, ``(found, fpeak)`` (R, T) for
    the first whose frequency lies strictly inside the accept range.  Bin
    mapping ``bin = floor(freq * F / (Fs / 2))``, ``freq = bin * (Fs / 2) / F``.
    ``peaks`` is :func:`_spectral_peaks` of ``mag``."""
    F = mag.shape[-2]
    dev = mag.device
    is_max, C = peaks
    to_bin, to_freq = f32_recip(Fs / 2.0, dev, times=F), f32_recip(F, dev, times=Fs / 2.0)
    bin_lo = torch.floor(search_lo * to_bin).to(torch.int64)
    bin_hi = torch.floor(search_hi * to_bin).to(torch.int64)

    # the bins each row may pick, (R, 1, F) (bounds of shape (R,) or ()
    # broadcast as (R, 1, 1) or (1, 1)): inside the search band (the
    # interior of [bin_lo, bin_hi)) at a frequency inside the accept band
    rows = torch.arange(F, device=dev)
    freq = rows.to(torch.float32) * to_freq
    lo = bin_lo[..., None, None]
    band = ((rows > lo) & (rows < bin_hi[..., None, None] - 1)
            & (freq > accept_lo[..., None, None]) & (freq < accept_hi[..., None, None]))
    # the rank of a peak among the peaks above bin_lo: C less C at bin_lo
    # (0 where bin_lo is outside the spectrum)
    at_lo = torch.clamp(lo, 0, F - 1).expand(C.shape[:-1] + (1,))
    C_lo = torch.where((lo >= 0) & (lo < F), torch.gather(C, -1, at_lo), 0)
    elig = is_max & band & (C - C_lo <= num_peaks)
    found = elig.any(dim=-1)
    first_bin = torch.argmax(elig.to(torch.uint8), dim=-1)
    fpeak = torch.where(found, first_bin.to(torch.float32) * to_freq, 0.0)
    return found.to(torch.int32), fpeak


def _nonzero_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean of the nonzero values of each row, 0 for a row of zeros."""
    cnt = torch.sum(x != 0, dim=-1)
    mean = tree_sum(x, dim=-1) / torch.clamp_min(cnt, 1).to(x.dtype)
    return torch.where(cnt > 0, mean, 0.0)


# ---------------------------------------------------------------------------
# TD pulse characteristics
# ---------------------------------------------------------------------------


def _pulse_characteristics(audio: torch.Tensor, num_frames: int, cfg: RoeConfig,
                           store=_keep) -> Dict[str, torch.Tensor]:
    """(``roe.py:258-324``) for rows ``audio`` (R, L): the 400-900 Hz
    order-4 band-pass (K4), block energies, the rising energy ratio, and
    per-frame kurtosis (Fisher, biased) and crest of the unfiltered frames.
    Arrays are (R, num_frames + 1), a trailing 0 as the reference pads."""
    N, H = cfg.frame_length, cfg.hop_length
    Fs = cfg.sample_rate
    dev = audio.device
    padded = tnf.pad(audio, (H, H))
    nyq = 0.5 * Fs
    filtered = store(sosfilt(butter_sos(4, [400.0 / nyq, 900.0 / nyq], "bandpass"), padded))

    frames_f = frame_signal(filtered, N, H)
    energy = tree_sum(frames_f * frames_f, dim=-1)
    n_e = energy.shape[-1]
    energy = energy[:, :num_frames] if n_e >= num_frames else tnf.pad(energy, (0, num_frames - n_e))

    # rising energy over the lower of the two frames before it (i >= 2)
    e = energy
    e1 = tnf.pad(e[:, :-1], (1, 0))
    e2 = tnf.pad(e[:, :-2], (2, 0))
    last = torch.where(e2 < e1, e2, e1)
    frame = torch.arange(num_frames, device=dev)
    diff_energy = torch.where((frame >= 2) & (e > last), e / (last + f32(1e-12, dev)), 0.0)

    # kurtosis and crest of the unfiltered padded frames (i > 0)
    frames_p = frame_signal(padded, N, H)[:, :num_frames]
    inv_n = f32_recip(N, dev)
    d = frames_p - (tree_sum(frames_p, dim=-1) * inv_n)[..., None]
    dd = d * d
    m2 = tree_sum(dd, dim=-1) * inv_n
    m4 = tree_sum(dd * dd, dim=-1) * inv_n
    pos = m2 > 0
    kurt = torch.where(pos, m4 / torch.where(pos, m2 * m2, 1.0) - 3.0, -3.0)
    rms = torch.sqrt(tree_sum(frames_p * frames_p, dim=-1) * inv_n)
    crest = torch.amax(torch.abs(frames_p), dim=-1) / (rms + f32(1e-12, dev))
    gate0 = frame > 0
    kurt = torch.where(gate0, kurt, 0.0)
    crest = torch.where(gate0, crest, 0.0)
    return {
        "kurtosis": tnf.pad(kurt, (0, 1)),
        "crest_factor": tnf.pad(crest, (0, 1)),
        "diff_energy": tnf.pad(diff_energy, (0, 1)),
    }


# ---------------------------------------------------------------------------
# per-chunk analysis, chunks as rows
# ---------------------------------------------------------------------------


def _harmonic_threshold(thrs, hn: int) -> float:
    return thrs[hn] if hn < len(thrs) else thrs[-1]


def _sum_harmonics(v: torch.Tensor) -> torch.Tensor:
    """Sum over the harmonic axis (dim 1) left to right."""
    acc = v[:, 0]
    for h in range(1, v.shape[1]):
        acc = acc + v[:, h]
    return acc


def _analyse_rows(chunks: torch.Tensor, cfg: RoeConfig, store) -> Dict[str, torch.Tensor]:
    """``_analyse_chunk`` (``roe.py:341-472``) for each row of ``chunks``
    (R, L), every firmware chunk from zero filter state (``nf`` 0: no noise
    estimate)."""
    Fs = cfg.sample_rate
    N, H = cfg.frame_length, cfg.hop_length
    op_lo, op_hi = cfg.op_freq_range
    dev = chunks.device

    # operating-band causal band-pass, order 8 (K4)
    nyq = 0.5 * Fs
    audio = store(sosfilt(butter_sos(8, [op_lo / nyq, op_hi / nyq], "bandpass"),
                          store(chunks.to(torch.float32))))
    # only |S| is read downstream: the square root of the power
    mag = store(torch.sqrt(stft_power(audio, n_fft=N, hop=H)))
    F, T = mag.shape[-2], mag.shape[-1]

    t_res = _pulse_characteristics(audio, T, cfg, store)

    Y = mag  # log_factor 0
    M = cfg.min_average_len
    thrs = cfg.harmonic_threshold

    # ---- harmonic 0: fixed band [fn, fn + 300] ----
    f0_lo, f0_hi = f32(cfg.fn, dev), f32(cfg.fn + 300.0, dev)
    mask0 = _band_mask_bins(f0_lo, f0_hi, Fs, N, F)
    novk = _novelty_spectrum(torch.where(mask0[:, None], Y, 0.0), M, thrs[0])
    peaks = _spectral_peaks(mag)
    peaks0, fpeak0 = _find_first_peak_in_range(
        mag, f32(op_lo, dev), f32(op_hi, dev), f0_lo, f0_hi, Fs, cfg.max_peaks, peaks)
    # novelty rows are T + 1 long (trailing zero); only the first T are gated
    gate0 = tnf.pad((novk[:, :T] != 0) & (peaks0 == 0), (0, 1))
    novk = torch.where(gate0, 0.0, novk)

    frain_mean = _nonzero_mean(fpeak0)

    # ---- harmonics 1..n-1 in bands centred on multiples of frain_mean ----
    n_lo, n_hi = cfg.n_freq_range
    in_natural = (frain_mean >= n_lo) & (frain_mean <= n_hi)
    # the last harmonic is dropped when its search range overflows the band
    overflow_last = (frain_mean * cfg.num_harmonics + 300.0) > (op_hi + 100.0)

    nov_list = [novk]
    n_harm = cfg.num_harmonics - 1
    for hn in range(1, n_harm + 1):
        centre = frain_mean * (hn + 1)
        b_lo = centre - 100.0
        b_hi = b_lo + 300.0
        maskh = _band_mask_bins(b_lo, b_hi, Fs, N, F)
        novx = _novelty_spectrum(torch.where(maskh[..., None], Y, 0.0), M,
                                         _harmonic_threshold(thrs, hn))
        # search range re-centred (``update_search_freq_range``)
        s_lo = torch.clamp_min(centre - 200.0, op_lo)
        s_hi = torch.clamp_max(centre + 300.0, op_hi)
        _, fpeak_h = _find_first_peak_in_range(mag, s_lo, s_hi, b_lo, b_hi, Fs, cfg.max_peaks,
                                               peaks)
        gate_h = tnf.pad((novx[:, :T] != 0) & (fpeak_h == 0), (0, 1))
        novx = torch.where(gate_h, 0.0, novx)

        active = in_natural if hn < n_harm else in_natural & ~overflow_last
        nov_list.append(torch.where(active[:, None], novx, 0.0))

    nov = torch.stack(nov_list, dim=1)  # (R, n_harmonics, T + 1)
    # harmonics count only where harmonic 0 has novelty
    nov = torch.cat([nov[:, :1], torch.where(nov[:, :1] == 0.0, 0.0, nov[:, 1:])], dim=1)

    thr_hn = f32(cfg.rain_thr_hn, dev)
    nov_hn = _sum_harmonics(nov)
    # the reference clamps > thr to thr, then zeroes < thr: thr survives at >= thr
    raining = torch.where(nov_hn >= thr_hn, thr_hn, 0.0)
    rain_drops = torch.sum(raining >= 1.0, dim=-1).to(torch.int32)
    return {"rain_drops": rain_drops, "frain_mean": frain_mean, **t_res}


# ---------------------------------------------------------------------------
# whole clips
# ---------------------------------------------------------------------------


def _chunk_plan(cfg: RoeConfig, n_samples: int) -> List[Tuple[int, int]]:
    """``(offset, length)`` of every chunk analysed (``roe.py:484-503``):
    2 s firmware chunks over ``check_duration``, a chunk that starts past
    the clip or has less than 1 s of it skipped, the last one cut to the
    clip."""
    Fs = cfg.sample_rate
    plan = []
    remaining, offset = cfg.check_duration, 0.0
    while remaining > 0:
        part = min(remaining, MAX_DURATION_FW)
        read_size = int(cfg.frame_length * (part * Fs / cfg.frame_length))
        read_off = int(Fs * offset)
        if read_off < n_samples and n_samples - read_off >= Fs:
            plan.append((read_off, min(read_size, n_samples - read_off)))
        remaining -= part
        offset += part
    return plan


def _analyse_chunks(x: torch.Tensor, cfg: RoeConfig, store) -> List[Dict[str, torch.Tensor]]:
    """Every chunk of every clip of ``x`` (B, n): the chunks of one length
    stacked as rows (chunk-major) and analysed together.  Returns one dict
    of (B, ...) tensors per chunk, in plan order."""
    B = x.shape[0]
    plan = _chunk_plan(cfg, x.shape[-1])
    out: List[Dict[str, torch.Tensor]] = [{} for _ in plan]
    for take in sorted({t for _, t in plan}, reverse=True):
        members = [j for j, (_, t) in enumerate(plan) if t == take]
        rows = torch.cat([x[:, plan[j][0] : plan[j][0] + take] for j in members], dim=0)
        res = _analyse_rows(rows, cfg, store)
        for i, j in enumerate(members):
            out[j] = {k: v[i * B : (i + 1) * B] for k, v in res.items()}
    return out


_CONCAT_KEYS = ("kurtosis", "crest_factor", "diff_energy")


def _roe_batch(x: torch.Tensor, cfg: RoeConfig, store) -> Dict[str, torch.Tensor]:
    """``_roe_traced`` (``roe.py:480-570``) for each clip of ``x`` (B, n):
    the chunk arrays concatenated over time, the TD gate and the FP/FN
    combiner: the per-clip counts and ``frain_mean``."""
    chunks = _analyse_chunks(x, cfg, store)
    merged = {k: torch.cat([c[k] for c in chunks], dim=-1) for k in _CONCAT_KEYS}
    rdc = chunks[0]["rain_drops"]
    for c in chunks[1:]:
        rdc = rdc + c["rain_drops"]
    frain_mean = chunks[-1]["frain_mean"]

    duration = cfg.check_duration
    rain_drop_threshold = math.ceil(cfg.min_drop_count * duration)
    raining_flag = rdc > rain_drop_threshold

    # TD gate and FP/FN combiner
    peaks = ((merged["kurtosis"] > cfg.kurtosis_thr)
             & (merged["crest_factor"] > cfg.crest_thr)
             & (merged["diff_energy"] > cfg.diff_energy_thr))
    rain_peaks_count = torch.sum(peaks, dim=-1).to(torch.int32)

    # the FP/FN combiner (``roe.py:538-562``, both on): zero where the clip
    # is not raining
    mod = rdc
    promote = ~raining_flag & ((rdc > cfg.rain_drop_max_thr)
                               | (rain_peaks_count > cfg.rain_peaks_max_thr))
    raining2 = raining_flag | promote
    mod = torch.where(promote, torch.maximum(rdc, rain_peaks_count), mod)
    demote = raining2 & ((rain_peaks_count < cfg.rain_peaks_min_thr) | (rdc < rain_drop_threshold))
    raining2 = raining2 & ~demote
    mod = torch.where(demote, 0, mod)
    zero = torch.zeros_like(rdc)
    return {"rain_drop_count": torch.where(raining2, rdc, zero),
            "rain_drop_count_mod": torch.where(raining2, mod, zero),
            "rain_peaks_count": rain_peaks_count, "frain_mean": frain_mean}
