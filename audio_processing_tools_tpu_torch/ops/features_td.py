"""Time-domain frame features, batched over clips.

Counterpart of ``audio_processing_tools_tpu/ops/features_td.py``: the TD
front end ``td_input_signal`` (``:49-85``, modes ``default``,
``comb_filter`` and ``bandpass``), crest factor and kurtosis per frame
(``:479-484``), the three block-energy features
(``block_energy_peak_features``, ``:205-289``, with
``_window_argmax_peak_width``, ``:106-177``), ``subframe_energy``
(``:297-306``) and the envelope-shape features
(``subframe_peak_shape_features`` and the subframe-to-frame maps,
``:309-430``, used at ``:493-514``).  The JAX functions are 1-D and vmapped
over clips; here every function takes ``(..., n)`` and carries the leading
axes through.
"""

from __future__ import annotations

from typing import Collection, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as tnf

from audio_processing_tools_tpu_torch.ops.filters import design_bandpass, sosfilt, sosfiltfilt
from audio_processing_tools_tpu_torch.ops.framing import frame_signal, num_frames
from audio_processing_tools_tpu_torch.ops.stats import crest_factor, kurtosis

TD_CORE_FEATURE_NAMES = (
    "frame_times",
    "td_crest_factor",
    "td_kurtosis",
    "td_block_energy_crest",
    "td_block_peak_width_50",
    "td_block_post_pre_energy_ratio",
)

TD_ENVELOPE_FEATURE_NAMES = (
    "td_energy_envelope",
    "td_rise_time_sec",
    "td_fall_time_sec",
    "td_rise_slope",
    "td_fall_slope",
    "td_peak_energy",
)

TD_FEATURE_NAMES = TD_CORE_FEATURE_NAMES + TD_ENVELOPE_FEATURE_NAMES

_BLOCK_NAMES = ("td_block_energy_crest", "td_block_peak_width_50",
                "td_block_post_pre_energy_ratio")


def _bandpass_filtfilt_or_filt(x: torch.Tensor, sr: float, band, order: int) -> torch.Tensor:
    """``sosfiltfilt``, or the causal ``sosfilt`` for inputs no longer than
    its padlen (``features_td.py:49-58``)."""
    sos = design_bandpass(sr, float(band[0]), float(band[1]), order)
    ntaps = 2 * sos.shape[0] + 1 - int(min((sos[:, 2] == 0).sum(), (sos[:, 5] == 0).sum()))
    if x.shape[-1] > 3 * ntaps:
        return sosfiltfilt(sos, x)
    return sosfilt(sos, x)


def td_input_signal(
    x: torch.Tensor,
    sr: float,
    *,
    td_input_mode: str = "default",
    td_input_band: Optional[Tuple[float, float]] = None,
    operating_band: Tuple[float, float] = (400.0, 3500.0),
    mode_bands: Optional[Tuple[Tuple[float, float], ...]] = None,
    bp_order: int = 4,
) -> torch.Tensor:
    """The TD front-end waveform (``features_td.py:61-85``)."""
    mode = str(td_input_mode).lower()
    if mode == "default":
        return x
    if mode == "comb_filter":
        if not mode_bands:
            return _bandpass_filtfilt_or_filt(x, sr, operating_band, bp_order)
        y = torch.zeros_like(x)
        for band in mode_bands:
            y = y + _bandpass_filtfilt_or_filt(x, sr, band, bp_order)
        return y
    if mode == "bandpass":
        band = td_input_band if td_input_band is not None else operating_band
        return _bandpass_filtfilt_or_filt(x, sr, band, bp_order)
    raise ValueError(f"Unsupported td_input_mode={td_input_mode!r}")


def _pick(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``a[..., t, idx[..., t]]``."""
    return torch.gather(a, -1, idx[..., None]).squeeze(-1)


def _window_argmax_peak_width(env_w: torch.Tensor, valid: torch.Tensor,
                              eps: float) -> torch.Tensor:
    """Half-prominence width of each window's argmax peak (``:106-177``).

    ``env_w``: (..., T, W) block-envelope windows; ``valid``: (T, W) mask.
    The width is nonzero only when the argmax is interior, a strict local
    peak with adjacent prominence > eps, and the peak value > eps; it
    matches ``scipy.signal.peak_widths(..., rel_height=0.5)`` for that peak.
    """
    W = env_w.shape[-1]
    e = torch.where(valid, env_w, -torch.inf)
    p = torch.argmax(e, dim=-1)
    peak = torch.amax(e, dim=-1)
    count = valid.sum(-1)

    j = torch.arange(W, device=env_w.device)
    pc = p[..., None]
    left_base = torch.amin(torch.where((j <= pc) & valid, env_w, torch.inf), dim=-1)
    right_base = torch.amin(torch.where((j >= pc) & valid, env_w, torch.inf), dim=-1)
    prom = peak - torch.maximum(left_base, right_base)
    h = peak - 0.5 * prom
    hc = h[..., None]

    # left crossing: largest j < p with env[j] <= h
    le_mask = (j < pc) & valid & (env_w <= hc)
    has_left = le_mask.any(-1)
    i_stop = torch.amax(torch.where(le_mask, j, -1), dim=-1)
    i_left = torch.where(has_left, i_stop, 0)
    e_i = _pick(env_w, i_left)
    e_i1 = _pick(env_w, torch.clamp(i_left + 1, max=W - 1))
    interp_l = torch.where(
        has_left & (e_i < h),
        (h - e_i) / torch.where(e_i1 != e_i, e_i1 - e_i, 1.0),
        0.0,
    )
    left_ip = i_left.to(env_w.dtype) + interp_l

    # right crossing: smallest j > p with env[j] <= h
    re_mask = (j > pc) & valid & (env_w <= hc)
    has_right = re_mask.any(-1)
    j_stop = torch.amin(torch.where(re_mask, j, W), dim=-1)
    i_right = torch.where(has_right, j_stop, torch.clamp(count - 1, min=0))
    e_j = _pick(env_w, i_right)
    e_jm1 = _pick(env_w, torch.clamp(i_right - 1, min=0))
    interp_r = torch.where(
        has_right & (e_j < h),
        (h - e_j) / torch.where(e_jm1 != e_j, e_jm1 - e_j, 1.0),
        0.0,
    )
    right_ip = i_right.to(env_w.dtype) - interp_r

    width = right_ip - left_ip

    p_prev = _pick(env_w, torch.clamp(p - 1, min=0))
    p_next = _pick(env_w, torch.clamp(p + 1, max=W - 1))
    adjacent_prom = peak - torch.maximum(p_prev, p_next)
    ok = (
        (count >= 3)
        & (p > 0)
        & (p < count - 1)
        & (adjacent_prom > eps)
        & (peak > eps)
        & torch.isfinite(width)
        & (width > 0.0)
    )
    return torch.where(ok, width, 0.0)


def _block_envelope(x: torch.Tensor, B: int, H: int, smooth: bool) -> torch.Tensor:
    """RMS block-amplitude envelope (``:185-202``)."""
    n = x.shape[-1]
    n_blocks = 1 + (n - B) // H if n >= B else 0
    if n_blocks <= 0:
        return x.new_zeros(x.shape[:-1] + (0,))
    blocks = frame_signal(x, B, H)
    sums = torch.sum(blocks * blocks, dim=-1)
    env = torch.sqrt(torch.clamp(sums / float(B), min=0.0))
    if smooth and n_blocks >= 3:
        padded = tnf.pad(env, (1, 1))
        env = 0.25 * padded[..., :-2] + 0.5 * padded[..., 1:-1] + 0.25 * padded[..., 2:]
    return env


def block_energy_peak_features(
    x_td: torch.Tensor,
    *,
    frame_len: int,
    hop: int,
    block_len: int = 8,
    block_hop: Optional[int] = None,
    post_pre_blocks: int = 4,
    smooth: bool = True,
    eps: float = 1e-9,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(crest, width50, log post/pre ratio) per frame, each ``(..., T)``."""
    B = max(1, int(block_len))
    H = max(1, int(block_hop) if block_hop is not None else B)
    n = x_td.shape[-1]
    T = num_frames(n, frame_len, hop)
    if n < B or T == 0:
        z = x_td.new_zeros(x_td.shape[:-1] + (T,))
        return z, z, z

    env = _block_envelope(x_td, B, H, smooth)  # (..., n_blocks)
    n_blocks = env.shape[-1]
    W = max(1, int(np.ceil(frame_len / H)))
    stride = max(1, int(np.round(hop / H)))

    # window t is env[t*stride : t*stride + W] with an m-block apron on both
    # sides so the pre/post sums never leave the window
    m = max(1, int(post_pre_blocks))
    b0 = np.arange(T) * stride
    need = m + (T - 1) * stride + W + m
    env_pad = tnf.pad(env, (m, max(need - m - n_blocks, 0)))
    We = W + 2 * m
    pad_w = -We % stride
    env_we = frame_signal(tnf.pad(env_pad, (0, pad_w)), We + pad_w, stride)[..., :T, :We]
    jj_e = np.arange(We)[None, :]
    valid_e = torch.as_tensor((b0[:, None] - m + jj_e >= 0)
                              & (b0[:, None] - m + jj_e < n_blocks), device=x_td.device)
    env_we = torch.where(valid_e, env_we, 0.0)
    env_w = env_we[..., m : m + W]
    valid = valid_e[:, m : m + W]

    count = valid.sum(-1)
    nonempty = count > 0

    rms = torch.sqrt(torch.sum(env_w * env_w, dim=-1) / torch.clamp(count, min=1))
    masked = torch.where(valid, env_w, -torch.inf)
    p_local = torch.argmax(masked, dim=-1)
    peak = torch.where(nonempty, torch.amax(masked, dim=-1), 0.0)
    crest = torch.where(nonempty, peak / torch.clamp(rms, min=eps), 0.0)

    width = torch.where(nonempty, _window_argmax_peak_width(env_w, valid, eps), 0.0)

    # post/pre energy around the peak (columns q-m..q-1 and q+1..q+m of the
    # extended window, q = peak position there)
    jj = torch.as_tensor(jj_e, device=x_td.device)
    q = (p_local + m)[..., None]
    pre_valid = (jj >= q - m) & (jj <= q - 1) & valid_e
    post_valid = (jj >= q + 1) & (jj <= q + m) & valid_e
    pre_e = (torch.sum(torch.where(pre_valid, env_we, 0.0), -1)
             / torch.clamp(pre_valid.sum(-1), min=1))
    post_e = (torch.sum(torch.where(post_valid, env_we, 0.0), -1)
              / torch.clamp(post_valid.sum(-1), min=1))
    ratio = torch.where(nonempty, torch.log((post_e + eps) / (pre_e + eps)), 0.0)
    return crest, width, ratio


def subframe_energy(x_td: torch.Tensor, B: int, H: int) -> torch.Tensor:
    """Mean energy per subframe (``:297-306``), ``(..., n_sub)``."""
    B, H = max(1, int(B)), max(1, int(H))
    n = x_td.shape[-1]
    if n == 0:
        return x_td.new_zeros(x_td.shape[:-1] + (0,))
    if n < B:
        return torch.mean(x_td * x_td, dim=-1, keepdim=True)
    subs = frame_signal(x_td, B, H)
    return torch.sum(subs * subs, dim=-1) / float(B)


def _first_true_index(mask: torch.Tensor, default: torch.Tensor) -> torch.Tensor:
    N = mask.shape[-1]
    j = torch.arange(N, device=mask.device)
    return torch.where(mask.any(-1), torch.amin(torch.where(mask, j, N), dim=-1), default)


def _last_true_index(mask: torch.Tensor, default: torch.Tensor) -> torch.Tensor:
    j = torch.arange(mask.shape[-1], device=mask.device)
    return torch.where(mask.any(-1), torch.amax(torch.where(mask, j, -1), dim=-1), default)


def subframe_peak_shape_features(sub_energy_vals: torch.Tensor, *, subframe_hop: int,
                                 fs: float, eps: float = 1e-9) -> Dict[str, torch.Tensor]:
    """Rise/fall shape of the subframe-energy envelope at its local peaks
    (``features_td.py:325-406``), as masked (..., N, N) reductions.  Returns
    per-subframe ``env_smooth``, ``rise_time``, ``fall_time``,
    ``rise_slope``, ``fall_slope`` and ``peak_level``."""
    env = sub_energy_vals
    N = env.shape[-1]
    dt = float(subframe_hop) / float(fs)
    names = ("env_smooth", "rise_time", "fall_time", "rise_slope", "fall_slope", "peak_level")
    if N == 0:
        return {k: torch.zeros_like(env) for k in names}
    dev = env.device

    if N >= 3:
        padded = tnf.pad(env, (1, 1))
        env_s = 0.25 * padded[..., :-2] + 0.5 * padded[..., 1:-1] + 0.25 * padded[..., 2:]
        is_peak = tnf.pad((env_s[..., 1:-1] >= env_s[..., :-2]) & (env_s[..., 1:-1] > env_s[..., 2:]),
                          (1, 1))
    elif N == 2:
        env_s = env
        is_peak = torch.arange(N, device=dev) == torch.argmax(env_s, dim=-1, keepdim=True)
    else:
        env_s = env
        is_peak = torch.ones(env.shape, dtype=torch.bool, device=dev)

    p = torch.arange(N, device=dev)
    peak = torch.clamp(env_s, min=eps)
    lo = 0.1 * peak
    hi = 0.9 * peak
    j = p[None, :]
    pc = p[:, None]
    ev = env_s[..., None, :]
    lo_c, hi_c = lo[..., :, None], hi[..., :, None]

    # rise: i_lo = last index <= p with env <= lo (else 0); i_hi = first index
    # in [i_lo, p] with env >= hi (else p)
    i_lo = _last_true_index((j <= pc) & (ev <= lo_c), torch.zeros_like(p))
    i_hi = _first_true_index((j >= i_lo[..., None]) & (j <= pc) & (ev >= hi_c), p)
    rise_dt = torch.clamp(i_hi - i_lo, min=0).to(env.dtype) * dt

    # fall: first offset >= 1 from p with env <= hi (else 0), then the first
    # offset from there with env <= lo (else the rest of the envelope)
    right_off = j - pc
    below_hi = (right_off >= 1) & (ev <= hi_c)
    i_hi_fall = torch.where(below_hi.any(-1), _first_true_index(below_hi, p) - p, 0)
    below_lo = (right_off >= i_hi_fall[..., None]) & (ev <= lo_c)
    i_lo_fall = torch.where(below_lo.any(-1), _first_true_index(below_lo, p) - p,
                            torch.clamp(N - p - 1, min=0))
    fall_dt = torch.clamp(i_lo_fall, min=0).to(env.dtype) * dt

    amp = torch.clamp(hi - lo, min=0.0)
    rise_slope = amp / torch.clamp(rise_dt, min=dt)
    fall_slope = amp / torch.clamp(fall_dt, min=dt)
    return {
        "env_smooth": env_s,
        "rise_time": torch.where(is_peak, rise_dt, 0.0),
        "fall_time": torch.where(is_peak, fall_dt, 0.0),
        "rise_slope": torch.where(is_peak, rise_slope, 0.0),
        "fall_slope": torch.where(is_peak, fall_slope, 0.0),
        "peak_level": torch.where(is_peak, peak, 0.0),
    }


def _subframes_padded(sub_vals: torch.Tensor, n_frames: int) -> torch.Tensor:
    """The first ``n_frames + 1`` subframe values, zero-filled."""
    n = min(sub_vals.shape[-1], n_frames + 1)
    return tnf.pad(sub_vals[..., :n], (0, n_frames + 1 - n))


def _frame_max_from_subframes(sub_vals: torch.Tensor, n_frames: int) -> torch.Tensor:
    """max(sub[t], sub[t+1]) with zero fill (``features_td.py:409-416``)."""
    if n_frames == 0 or sub_vals.shape[-1] == 0:
        return sub_vals.new_zeros(sub_vals.shape[:-1] + (n_frames,))
    padded = _subframes_padded(sub_vals, n_frames)
    return torch.maximum(padded[..., :-1], padded[..., 1:])


def _frame_sum_from_subframes(sub_vals: torch.Tensor, n_frames: int) -> torch.Tensor:
    """sub[t] + sub[t+1] with zero fill (``features_td.py:419-430``)."""
    if n_frames == 0 or sub_vals.shape[-1] == 0:
        return sub_vals.new_zeros(sub_vals.shape[:-1] + (n_frames,))
    padded = _subframes_padded(sub_vals, n_frames)
    return padded[..., :-1] + padded[..., 1:]


def extract_td_features(
    x: torch.Tensor,
    *,
    fs: int,
    frame_len: int,
    hop: int,
    operating_band: Tuple[float, float] = (400.0, 3500.0),
    mode_bands: Optional[Tuple[Tuple[float, float], ...]] = None,
    td_input_mode: str = "default",
    td_input_band: Optional[Tuple[float, float]] = None,
    bp_order: int = 4,
    subframe_len: int = 128,
    subframe_hop: int = 128,
    block_energy_len: int = 8,
    block_energy_hop: Optional[int] = None,
    block_energy_post_pre_blocks: int = 4,
    block_energy_smooth_enable: bool = True,
    envelope_features_enable: bool = False,
    eps: float = 1e-9,
    names: Optional[Collection[str]] = None,
) -> Dict[str, torch.Tensor]:
    """TD features of ``(..., n)`` clips, each ``(..., T)`` with
    ``T = 1 + (n - frame_len) // hop`` (``features_td.py:444-520``).

    ``names`` limits the work to the listed features (``frame_times`` is
    always returned); ``None`` gives every key of the JAX function, whose
    envelope features are zeros while they are disabled.
    """
    want = set(TD_FEATURE_NAMES if names is None else names)
    x_td = td_input_signal(
        x.to(torch.float32), fs, td_input_mode=td_input_mode, td_input_band=td_input_band,
        operating_band=operating_band, mode_bands=mode_bands, bp_order=bp_order)
    T = num_frames(x_td.shape[-1], frame_len, hop)
    frames = frame_signal(x_td, frame_len, hop)  # (..., T, frame_len)
    out: Dict[str, torch.Tensor] = {
        "frame_times": torch.arange(T, dtype=torch.float32, device=x.device) * hop / float(fs),
    }
    if "td_crest_factor" in want:
        out["td_crest_factor"] = crest_factor(frames, dim=-1, eps=eps, eps_in_rms=True)
    if "td_kurtosis" in want:
        if frame_len >= 4:
            kv = kurtosis(frames, dim=-1, fisher=False, bias=False)
            out["td_kurtosis"] = torch.where(torch.isfinite(kv), kv, 0.0)
        else:
            out["td_kurtosis"] = x_td.new_zeros(x_td.shape[:-1] + (T,))
    if want & set(_BLOCK_NAMES):
        out.update(zip(_BLOCK_NAMES, block_energy_peak_features(
            x_td, frame_len=frame_len, hop=hop, block_len=block_energy_len,
            block_hop=block_energy_hop, post_pre_blocks=block_energy_post_pre_blocks,
            smooth=block_energy_smooth_enable, eps=eps,
        )))
    want_env = want & set(TD_ENVELOPE_FEATURE_NAMES)
    if envelope_features_enable and want_env:
        shape = subframe_peak_shape_features(
            subframe_energy(x_td, subframe_len, subframe_hop),
            subframe_hop=subframe_hop, fs=fs, eps=eps)
        env = {"td_energy_envelope": _frame_sum_from_subframes(shape["env_smooth"], T)}
        for key, name in (("td_rise_time_sec", "rise_time"), ("td_fall_time_sec", "fall_time"),
                          ("td_rise_slope", "rise_slope"), ("td_fall_slope", "fall_slope"),
                          ("td_peak_energy", "peak_level")):
            env[key] = _frame_max_from_subframes(shape[name], T)
        out.update({k: env[k] for k in want_env})
    else:
        z = x_td.new_zeros(x_td.shape[:-1] + (T,))
        out.update({k: z for k in want_env})
    return out
