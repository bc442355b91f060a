"""Time-domain frame features, batched over clips.

Counterpart of ``audio_processing_tools_tpu/ops/features_td.py`` in its
default ``td_input_mode``: crest factor and kurtosis per frame
(``:479-484``), the three block-energy features
(``block_energy_peak_features``, ``:205-289``, with
``_window_argmax_peak_width``, ``:106-177``) and ``subframe_energy``
(``:297-306``).  The JAX functions are 1-D and vmapped over clips; here
every function takes ``(..., n)`` and carries the leading axes through.

The other ``td_input_mode`` front ends and the envelope-shape features
raise ``NotImplementedError`` (ROADMAP P9).
"""

from __future__ import annotations

from typing import Collection, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as tnf

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


def extract_td_features(
    x: torch.Tensor,
    *,
    fs: int,
    frame_len: int,
    hop: int,
    td_input_mode: str = "default",
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
    if str(td_input_mode).lower() != "default":
        raise NotImplementedError(
            f"td_input_mode={td_input_mode!r} is not ported yet (ROADMAP P9)")
    if envelope_features_enable:
        raise NotImplementedError(
            "td_envelope_features_enable is not ported yet (ROADMAP P9)")
    want = set(TD_FEATURE_NAMES if names is None else names)
    x_td = x.to(torch.float32)
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
    z = x_td.new_zeros(x_td.shape[:-1] + (T,))
    for k in TD_ENVELOPE_FEATURE_NAMES:
        if k in want:
            out[k] = z
    return out
