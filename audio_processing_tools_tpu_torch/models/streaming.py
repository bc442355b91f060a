"""Streaming chunked rain detection with explicit carried state.

Counterpart of ``audio_processing_tools_tpu/models/streaming.py``: the
flagship detector in its strictly causal, chunk-by-chunk form, the
deployment shape of the firmware (causal framing, a causal TD prefilter
with carried ``zi``, every tracker threading an explicit carry), and with
``compute_output_audio`` the causal suppressor, whose denoised audio lags
the input by ``n_fft - hop`` samples.

The chunk step is written once for ``B`` streams (:meth:`process_chunk` is
the ``B = 1`` case of :meth:`process_chunk_batch`); the state is a dict of
tensors with a leading stream axis and the JAX package's keys, and
:func:`state_from_jax` / :func:`state_to_jax` carry a stream across, leaf
for leaf.  Per chunk on the card:

  * the causal power, ``spectrogram_power(..., center=False)``: kernel K1;
  * the detector's noise PSD: kernel K2 with a carry;
  * the t-vs-(t-2) mode flux and the flux baselines: kernel K3 with a carry,
    all 1 + n_modes rows in one launch;
  * the causal TD prefilter, ``sosfilt`` with ``zi``: kernel K7;
  * with audio out, the suppressor's per-frame scan: kernel K8
    (``csrc/streaming.cu``: a walk over the frames that writes the gain,
    then a frame pass over all frames at once for the FFTs and the
    overlap-add), whose plain loop is :func:`_suppressor_plain`.

**Chunk invariance is bitwise**: any cut of a stream into hop-multiple
chunks, and any number of streams in a batch, gives the same bits as one
call.  The JAX package buys it with un-unrolled scans fenced by
optimization barriers.  Here every step is either elementwise, a kernel
that walks frames or samples in order, or a sum in a fixed order
(:func:`~audio_processing_tools_tpu_torch.ops.stats.tree_sum`) where the
JAX package reduces with a matrix product (the mode flux), a mean (crest
factor, kurtosis) or a sum (the SNR gate): a library reduction chooses its
order by shape, on the card by the number of outputs.  K8 computes its own
FFTs (K1's transform), so no library FFT sits on the audio path on the card.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from audio_processing_tools_tpu_torch import _kernels
from audio_processing_tools_tpu_torch.config import NoiseConfig, build_noise_config
from audio_processing_tools_tpu_torch.models.frame_classifier import (
    FrameClass,
    build_prefilter_sos,
    rain_frame_decision,
)
from audio_processing_tools_tpu_torch.models.spectral_noise import (
    _gain_consts,
    gain_freq_stage,
    gain_time_step,
)
from audio_processing_tools_tpu_torch.ops._device import device_constant, sorted_keys
from audio_processing_tools_tpu_torch.ops.filters import k7_state_dtype, sosfilt
from audio_processing_tools_tpu_torch.ops.framing import frame_signal
from audio_processing_tools_tpu_torch.ops.spectrogram import (
    N_FFTS,
    chirp_size,
    chirpz_tables,
    chunk_frames,
    fft_shape,
    four_step_plan,
    kernel_tables,
    spectrogram_power,
    tile_elems,
)
from audio_processing_tools_tpu_torch.ops.stats import nan_to_num, tree_sum
from audio_processing_tools_tpu_torch.ops.stft import fft_frequencies
from audio_processing_tools_tpu_torch.ops.trackers import (
    PsdTrackParams,
    _psd_derived,
    causal_low_quantile_baseline_chunk,
    make_psd_params,
    make_psd_track_step,
    noise_psd_track_chunk,
)
from audio_processing_tools_tpu_torch.ops.windows import hann_window

State = Dict[str, Any]


class _Static(NamedTuple):
    sr: int
    n_fft: int
    hop: int
    rows: slice                # the operating band's spectrogram rows
    mode_masks: np.ndarray     # (n_modes, K) bool
    mode_index: np.ndarray     # (n_modes, L): band bins of each mode, K = a zero bin
    fps: float
    psd_params: PsdTrackParams
    td_sos: Optional[np.ndarray]


class _Audio(NamedTuple):
    window: np.ndarray         # (n_fft,) float32
    inv_ws: np.ndarray         # (hop,) float32: 1 / steady-state sum of w^2
    inv_ws_tail: np.ndarray    # (n_fft - hop,) float32: the drained tail's
    snr_cols: Optional[np.ndarray]


# ---------------------------------------------------------------------------
# Fixed-order per-frame statistics
# ---------------------------------------------------------------------------


def _crest_factor(frames: torch.Tensor, eps: float) -> torch.Tensor:
    """``ops/stats.py::crest_factor`` over the last axis with the mean
    square summed by :func:`tree_sum`."""
    n = frames.new_full((), float(frames.shape[-1]))
    peak = torch.amax(torch.abs(frames), dim=-1)
    rms = torch.sqrt(tree_sum(frames * frames) / n + eps)
    return peak / torch.clamp(rms, min=eps)


def _kurtosis(frames: torch.Tensor) -> torch.Tensor:
    """``ops/stats.py::kurtosis(fisher=False, bias=False)`` over the last
    axis with the moments summed by :func:`tree_sum`."""
    nf = float(frames.shape[-1])
    n = frames.new_full((), nf)
    d = frames - (tree_sum(frames) / n)[..., None]
    d2 = d * d
    m2 = tree_sum(d2) / n
    m4 = tree_sum(d2 * d2) / n
    pos = m2 > 0
    if nf < 4:
        return torch.full(m2.shape, float("nan"), dtype=torch.float32, device=frames.device) + 3.0
    g2 = m4 / torch.where(pos, m2 * m2, 1.0) - 3.0
    g2 = torch.where(pos, g2, 0.0)
    G2 = ((nf + 1.0) * g2 + 6.0) * (nf - 1.0) / frames.new_full((), (nf - 2.0) * (nf - 3.0))
    return torch.where(pos, G2, -3.0) + 3.0


# ---------------------------------------------------------------------------
# K8: the streaming suppressor's per-frame scan
# ---------------------------------------------------------------------------

#: threads of K8's walk block at most (csrc/streaming.cu: kMaxWalkThreads)
_K8_WALK_THREADS = 1024
#: shared memory a K8 block may hold (csrc/streaming.cu: kSmemLimit)
_K8_SMEM_LIMIT = 232448


class _SupConsts(ctypes.Structure):
    """``SupConsts`` of ``csrc/streaming.cu``, field for field."""

    _f, _i = ctypes.c_float, ctypes.c_int
    _fields_ = [
        ("eta", _f), ("scale_alpha", _f), ("one_minus_scale_alpha", _f), ("step_floor", _f),
        ("warmup_need", _i), ("q", _f), ("neg_one_minus_q", _f), ("adaptive_q", _i),
        ("aq_min", _f), ("q_minus_aq_min", _f), ("ema_up", _f), ("ema_down", _f),
        ("track_maxr", _f), ("aq_alpha", _f), ("one_minus_aq_alpha", _f),
        ("maxr", _f), ("eps", _f), ("use_lagged", _i), ("n_snr", _i), ("snr1", _f),
        ("snr_pwr", _f), ("snr_pow", _i),
        ("adaptive_gain", _i), ("wiener", _i), ("th", _f), ("denom", _f),
        ("oversub_base", _f), ("oversub_span", _f), ("gain_floor", _f), ("gain_ceil", _f),
        ("n_taps", _i), ("alpha_base", _f),
        ("one_minus_alpha_base", _f),
        ("n_fft", _i), ("hop", _i), ("K", _i), ("row0", _i), ("n_frames", _i), ("n_streams", _i),
        ("chirp_n", _i),
    ]


class _SupIO(ctypes.Structure):
    """``SupIO`` of ``csrc/streaming.cu``, field for field."""

    _p, _l = ctypes.c_void_p, ctypes.c_longlong
    _fields_ = [
        ("xa", _p), ("xa_len", _l), ("P", _p), ("p_clip", _l), ("p_row", _l),
        ("frame_class", _p), ("noise_conf", _p), ("frame_idx", _p), ("tables", _p),
        ("snr_cols", _p),
        ("tracker", _p), ("scale", _p), ("prev_n", _p), ("wcount", _p), ("rain_ema", _p),
        ("is_first", _p), ("g_prev", _p), ("ola", _p), ("y", _p),
        ("o_tracker", _p), ("o_scale", _p), ("o_prev_n", _p), ("o_wcount", _p),
        ("o_rain_ema", _p), ("o_is_first", _p), ("o_g_prev", _p), ("o_ola", _p), ("gain", _p),
        ("taps", _p), ("chirp", _p), ("chirp_bt", _p), ("chirp_tab", _p),
        ("walk_scratch", _p), ("walk_scratch_floats", _l), ("frame_scratch", _p),
        ("frame_scratch_bytes", _l),
    ]


def _freq_taps(cfg: NoiseConfig) -> np.ndarray:
    """The normalized frequency-smoothing kernel ``gain_freq_stage`` applies,
    or an empty array when it applies none."""
    kernel = np.asarray(cfg.gain_freq_kernel, np.float32).reshape(-1)
    if kernel.size < 1:
        kernel = np.array([1.0], np.float32)
    kernel = kernel / (kernel.sum() + 1e-12)
    if not (bool(cfg.gain_freq_smooth_enable) and kernel.size > 1):
        return np.zeros(0, np.float32)
    return kernel


def k8_route(n_fft: int) -> str:
    """K8's frame pass for an even ``n_fft`` (hop = n_fft / 2), from
    :func:`fft_shape`'s ``(L, N)``, L = n_fft / 2: ``"fft"`` (K1's
    power-of-two shared-memory FFT, 64 to 1024); ``"mixed"`` (K1's
    mixed-radix FFT, N = L) or ``"chirpz"`` (the chirp-z transform over N,
    :func:`chirp_size` of L) where a block holds two frames with all n_fft /
    2 + 1 bins as band bins (:func:`k8_mixed_slots`,
    :func:`k8_chirpz_slots`); else ``"global"`` (the four-step transform of
    N through device memory).  The route depends on n_fft alone, so every
    frame of a configuration runs the same arithmetic.  The direct DFT is a
    pass only comparisons force."""
    if n_fft in N_FFTS:
        return "fft"
    L, N = fft_shape(n_fft)
    if N == L:
        return "mixed" if k8_mixed_slots(n_fft, L + 1) else "global"
    return "chirpz" if k8_chirpz_slots(n_fft, L + 1) else "global"


def k8_mixed_slots(n_fft: int, K: int) -> int:
    """Frames a block of K8's mixed frame pass holds (``mixed_slots`` in the
    kernel's source): the most of 16, 8, 4, 2 whose two tile buffers of
    n_fft / 2 + 1 points and gains fit a block's shared memory, else 0."""
    for slots in (16, 8, 4, 2):
        if 16 * tile_elems(n_fft // 2 + 1, slots) + 4 * slots * K <= _K8_SMEM_LIMIT:
            return slots
    return 0


def k8_chirpz_slots(n_fft: int, K: int) -> int:
    """Frames a block of K8's chirp-z frame pass holds (``chirpz_slots``):
    the most of 16, 8, 4, 2 whose two tile buffers of :func:`chirp_size`
    (n_fft / 2) points and gains fit a block's shared memory, else 0."""
    Mc = chirp_size(n_fft // 2)
    for slots in (16, 8, 4, 2):
        if 16 * tile_elems(Mc, slots) + 4 * slots * K <= _K8_SMEM_LIMIT:
            return slots
    return 0


def k8_dft_slots(n_fft: int, K: int) -> int:
    """Frames a block of K8's DFT frame pass holds (``dft_slots`` in the
    kernel's source): the most of 16, 12, 8, 4 whose windowed frames,
    spectra, twiddles and gains fit a block's shared memory, else 0."""
    for slots in (16, 12, 8, 4):
        smem = 4 * n_fft * slots + 8 * (n_fft // 2 + 1) * slots + 8 * n_fft + 4 * slots * K
        if smem <= _K8_SMEM_LIMIT:
            return slots
    return 0


def k8_walk_floats(K: int, n_taps: int, n_snr: int, frames: int) -> int:
    """Floats of K8's walk rows at ``frames`` frames a round
    (``walk_floats`` in the kernel's source): per frame the padded gain row
    twice, P and N_eff per band bin and the two SNR trees, then the taps."""
    pad, m = n_taps // 2, 1 << max(n_snr - 1, 0).bit_length()
    return frames * (2 * (K + 2 * pad) + 2 * K + 2 * m) + n_taps


class WalkPlan(NamedTuple):
    narrow: bool  # suppressor_walk: one band bin a thread
    frames: int  # frames a round
    bins_per_thread: int
    threads: int
    smem: int  # shared bytes of a block
    scratch: int  # floats a stream of the global scratch (0: the rows are in shared memory)


def k8_walk_plan(K: int, n_taps: int, n_snr: int) -> WalkPlan:
    """K8's walk launch (``walk_plan`` in the kernel's source): one band bin a
    thread at four frames a round where K <= 1,024 and the rows fit shared
    memory (the main path); else ceil(K / 1,024) bins a thread at the most
    of 4, 2, 1 frames a round whose rows fit, or at one frame a round with
    the rows in a global scratch."""
    bpt = -(-K // _K8_WALK_THREADS)
    threads = 32 * ((-(-K // bpt) + 31) // 32)
    fits = [F for F in (4, 2, 1) if 4 * k8_walk_floats(K, n_taps, n_snr, F) <= _K8_SMEM_LIMIT]
    if not fits:
        return WalkPlan(False, 1, bpt, threads, 0, k8_walk_floats(K, n_taps, n_snr, 1))
    F = fits[0]
    return WalkPlan(K <= _K8_WALK_THREADS and F == 4, F, bpt, threads,
                    4 * k8_walk_floats(K, n_taps, n_snr, F), 0)


def k8_global_scratch_bytes(n_fft: int, frames: int) -> int:
    """Bytes of K8's global frame pass's scratch (``global_scratch_bytes``):
    two chunk buffers of N points a frame (:func:`chunk_frames`) and two
    overlap-add tails of hop samples."""
    N = fft_shape(n_fft)[1]
    return 16 * N * chunk_frames(N, frames) + 8 * (n_fft // 2)


#: K8's frame passes as its launcher numbers them
K8_ROUTES = {"fft": 0, "mixed": 1, "dft": 2, "chirpz": 3, "global": 4}


def k8_check_geometry(n_fft: int, hop: int, K: int, n_taps: int, n_snr: int,
                      route: str | None = None) -> None:
    """``ValueError`` for a geometry K8 does not take, which is what the JAX
    package refuses too: ``hop != n_fft / 2``, band bins outside 1 to n_fft
    / 2 + 1, more SNR columns than band bins.  Every other geometry, with any
    number of taps, takes :func:`k8_route`'s pass.  A ``route`` forced for a
    comparison is refused where it does not take ``n_fft``: the FFT pass
    outside its sizes, the mixed pass without a plan or two frames a block,
    the chirp-z pass past two frames a block, the DFT pass past four, the
    global pass where the four-step split does not take the size."""
    if (n_fft < 2 or 2 * hop != n_fft or not 1 <= K <= n_fft // 2 + 1 or n_taps < 0
            or not 0 <= n_snr <= K):
        raise ValueError(f"streaming_suppressor: the CUDA kernel takes hop = n_fft / 2, 1 to "
                         f"n_fft / 2 + 1 band bins and at most K SNR columns; got n_fft {n_fft}, "
                         f"hop {hop}, K {K}, {n_taps} taps, {n_snr} columns")
    if route is None or route == k8_route(n_fft):
        return
    L, N = fft_shape(n_fft)
    takes = {
        "fft": lambda: n_fft in N_FFTS,
        "mixed": lambda: N == L and k8_mixed_slots(n_fft, K) > 0,
        "chirpz": lambda: k8_chirpz_slots(n_fft, K) > 0,
        "dft": lambda: k8_dft_slots(n_fft, K) > 0,
        "global": lambda: four_step_plan(N) is not None,
    }.get(route)
    if takes is None or not takes():
        raise ValueError(f"streaming_suppressor: the {route} frame pass does not take n_fft "
                         f"{n_fft} with K {K} band bins")


class Suppressor:
    """The constants of one configuration's streaming suppressor: what K8
    and its plain loop read besides the chunk's tensors."""

    def __init__(self, cfg: NoiseConfig, st: _Static, audio: _Audio):
        self.cfg, self.st, self.audio = cfg, st, audio
        self.K = st.rows.stop - st.rows.start
        self.maxr = float(np.clip(cfg.noise_psd_max_ratio, 0.0, 1.0))
        self.taps = _freq_taps(cfg)

    def tables(self, device) -> torch.Tensor:
        """K8's tables: window | 1/sum w^2 | a zero where hop is odd (the
        twiddles start 8-byte aligned: ``twiddle_offset``) | twiddles
        ``e^{-2 pi i k / n_fft}`` as (re, im) pairs, K1's (float64,
        rounded)."""
        n, hop = self.st.n_fft, self.st.hop

        def make():
            return np.concatenate([self.audio.window, self.audio.inv_ws,
                                   np.zeros(hop % 2, np.float32),
                                   kernel_tables(n)[1].reshape(-1)])

        return device_constant(("k8_tables", n, self.st.hop), device, make)

    def consts(self, B: int, T: int) -> _SupConsts:
        cfg, p = self.cfg, self.st.psd_params
        eta, step_floor, warmup_need = _psd_derived(p)
        g = _gain_consts(cfg)
        snr = self.audio.snr_cols
        pwr = float(cfg.snr_gating_power)
        c = _SupConsts(
            eta=eta, scale_alpha=p.ema_down, one_minus_scale_alpha=1.0 - p.ema_down,
            step_floor=step_floor, warmup_need=warmup_need, q=p.q, neg_one_minus_q=-(1.0 - p.q),
            adaptive_q=int(p.adaptive_q_enable), aq_min=p.adaptive_q_min,
            q_minus_aq_min=p.q - p.adaptive_q_min, ema_up=p.ema_up, ema_down=p.ema_down,
            track_maxr=p.maxr, aq_alpha=p.adaptive_q_alpha,
            one_minus_aq_alpha=1.0 - p.adaptive_q_alpha,
            maxr=self.maxr, eps=float(cfg.eps), use_lagged=int(bool(cfg.use_lagged_noise_psd)),
            n_snr=0 if snr is None else int(snr.size),
            snr1=max(1e-9, float(cfg.snr_gating_snr1)), snr_pwr=pwr,
            snr_pow=int(pwr != 1.0 and bool(np.isfinite(pwr)) and pwr > 0),
            adaptive_gain=int(g.adaptive), wiener=int(cfg.gain_mode.lower() == "wiener"),
            th=g.th, denom=g.denom, oversub_base=float(cfg.oversub_base),
            oversub_span=float(cfg.oversub_max - cfg.oversub_base),
            gain_floor=g.floor, gain_ceil=g.ceil, n_taps=int(self.taps.size),
            alpha_base=g.alpha_base, one_minus_alpha_base=1.0 - g.alpha_base,
            n_fft=self.st.n_fft, hop=self.st.hop, K=self.K, row0=self.st.rows.start,
            n_frames=T, n_streams=B,
        )
        return c


SupCarry = Tuple[Tuple[torch.Tensor, ...], torch.Tensor, torch.Tensor]


def _gate_power(gate: torch.Tensor, pwr: float) -> torch.Tensor:
    """``gate ** pwr`` for a gate in [0, 1] as ``exp(pwr * log(gate))`` in
    float64, rounded to float32, which K8 computes the same way.  CPU
    ``torch.pow`` takes another path for a vector than for a few values, so
    its bits would depend on the number of streams; this form's float64
    result lies far inside one float32 rounding step of either path."""
    g = gate.to(torch.float64)
    p = float(np.float32(pwr))  # the power as float32, as the JAX program takes it
    return torch.exp(torch.log(g) * p).to(torch.float32)


def _suppressor_plain(sup: Suppressor, xa: torch.Tensor, P: torch.Tensor,
                      frame_class: torch.Tensor, noise_conf: torch.Tensor,
                      frame_idx: torch.Tensor, carry: SupCarry):
    """K8's plain loop: ``sup_step`` of ``streaming.py:373-407`` over the
    chunk's frames, operation for operation.  The frame-local work (the
    forward FFT, S_hat, the inverse FFT, the window and the overlap-add) is
    done for all frames at once around the loop.  Returns ``(y, new_carry,
    G_out)`` with ``G_out`` the clipped gain (B, K, T)."""
    cfg, st = sup.cfg, sup.st
    n_fft, hop, rows = st.n_fft, st.hop, st.rows
    B, T = frame_class.shape
    dev = xa.device
    w = device_constant(("hann", n_fft), dev, lambda: hann_window(n_fft))
    spec = torch.fft.rfft(frame_signal(xa, n_fft, hop) * w, dim=-1)  # (B, T, F)
    P_band = P[:, rows, :]
    psd_c, G_prev, ola = carry
    step = make_psd_track_step(st.psd_params)
    gstep = gain_time_step(cfg)
    rain = frame_class != int(FrameClass.NOISE)
    seed = (frame_idx[:, None] + torch.arange(T, device=dev, dtype=frame_idx.dtype)) == 0
    use_lagged = bool(cfg.use_lagged_noise_psd)
    snr_cols = sup.audio.snr_cols
    if snr_cols is not None:
        cols = torch.as_tensor(snr_cols, device=dev)
        snr1 = max(1e-9, float(cfg.snr_gating_snr1))
        pwr = float(cfg.snr_gating_power)
    G_out = []
    for t in range(T):
        P_t = P_band[..., t]
        prev_N = psd_c[2]  # N at t - 1, for the lagged variant
        psd_c, N_t = step(psd_c, (P_t, rain[:, t]))
        N_used = torch.where(seed[:, t, None], N_t, prev_N) if use_lagged else N_t
        N_eff = torch.minimum(N_used, sup.maxr * P_t)
        gate = None
        if snr_cols is not None:
            snr = tree_sum(P_t[:, cols]) / (tree_sum(N_eff[:, cols]) + float(cfg.eps))
            gate = snr / (snr + snr1)
            if pwr != 1.0 and np.isfinite(pwr) and pwr > 0:
                gate = _gate_power(torch.clamp(gate, 0.0, 1.0), pwr)
            gate = torch.clamp(gate, 0.0, 1.0)[:, None]
        G_f = gain_freq_stage(cfg, P_t[..., None], N_eff[..., None], noise_conf[:, t, None],
                              gate)[..., 0]
        G_t = gstep(G_prev, G_f, noise_conf[:, t])
        # the stream's very first frame takes the unsmoothed gain
        G_t = torch.where(seed[:, t, None], G_f, G_t)
        G_out.append(torch.clamp(G_t, cfg.gain_floor, cfg.gain_ceil))
        G_prev = G_t
    G_out = torch.stack(G_out, dim=-1)  # (B, K, T)
    S_hat = spec.clone()
    S_hat[..., rows] = spec[..., rows] * G_out.transpose(1, 2)
    recon = torch.fft.irfft(S_hat, n=n_fft, dim=-1) * w  # (B, T, n_fft)
    inv_ws = device_constant(("stream_inv_ws", n_fft, hop), dev, lambda: sup.audio.inv_ws)
    before = torch.cat([ola[:, None, :], recon[:, :-1, hop:]], dim=1)
    y = ((recon[..., :hop] + before) * inv_ws).reshape(B, T * hop)
    return y, (psd_c, G_prev, recon[:, -1, hop:].contiguous()), G_out


def _suppressor_cuda(sup: Suppressor, xa: torch.Tensor, P: torch.Tensor,
                     frame_class: torch.Tensor, noise_conf: torch.Tensor,
                     frame_idx: torch.Tensor, carry: SupCarry, want_gain: bool = False,
                     route: str | None = None):
    """K8 on the card, its launches (the walk, then the frame pass: one
    launch, or for the global pass a few a chunk of frames) counted as one;
    returns what :func:`_suppressor_plain` returns, the gain only when
    ``want_gain``.  ``route`` is the frame pass, :func:`k8_route`'s by
    default; comparisons force another that takes the geometry
    (:func:`k8_check_geometry`)."""
    st = sup.st
    B, T = frame_class.shape
    K, hop, n_fft = sup.K, st.hop, st.n_fft
    dev = xa.device
    (trk, scl, pN, wc, rema, first), G_prev, ola = carry
    F = n_fft // 2 + 1
    checks = (("xa", xa, torch.float32, 2), ("P", P, torch.float32, 3),
              ("frame_class", frame_class, torch.int8, 2), ("noise_conf", noise_conf, torch.float32, 2),
              ("frame_idx", frame_idx, torch.int32, 1))
    for name, t, dtype, ndim in checks:
        _kernels.require_cuda(f"streaming_suppressor({name})", t, dtype, ndim)
    if xa.shape != (B, (T + 1) * hop) or P.shape != (B, F, T) or noise_conf.shape != (B, T):
        raise ValueError(f"streaming_suppressor: shapes xa {tuple(xa.shape)}, P {tuple(P.shape)}, "
                         f"noise_conf {tuple(noise_conf.shape)} do not fit {B} x {T} frames")
    name = "streaming_suppressor(carry)"
    cin = [_kernels.carry_vector(name, v, xa, n, dtype) for v, n, dtype in (
        (trk, B * K, torch.float32), (scl, B * K, torch.float32), (pN, B * K, torch.float32),
        (wc, B, torch.int32), (rema, B, torch.float32), (first, B, torch.bool),
        (G_prev, B * K, torch.float32), (ola, B * (n_fft - hop), torch.float32))]
    cin[5] = cin[5].view(torch.uint8)
    c = sup.consts(B, T)
    route = k8_route(n_fft) if route is None else route
    k8_check_geometry(n_fft, hop, K, int(sup.taps.size), c.n_snr, route)
    L, N = fft_shape(n_fft)
    chirp = (None,) * 3
    if route == "chirpz" or (route == "global" and N != L):
        c.chirp_n = chirp_size(L)
        chirp = device_constant(("chirpz_tables", n_fft), dev, lambda: chirpz_tables(n_fft))
    walk = k8_walk_plan(K, int(sup.taps.size), c.n_snr)
    walk_scratch = frame_scratch = None
    if walk.scratch:
        walk_scratch = torch.empty(B * walk.scratch, dtype=torch.float32, device=dev)
    if route == "global":
        frame_scratch = torch.empty(k8_global_scratch_bytes(n_fft, B * T) // 4,
                                    dtype=torch.float32, device=dev)
    y = torch.empty((B, T * hop), dtype=torch.float32, device=dev)
    out = [torch.empty_like(v) for v in cin]
    gain = torch.empty((B, K, T), dtype=torch.float32, device=dev)  # the walk's output, scratch
    tables = sup.tables(dev)
    taps = None
    if sup.taps.size:
        taps = device_constant(("k8_taps", sup.taps.tobytes()), dev, lambda: sup.taps)
    snr = sup.audio.snr_cols
    snr_t = None
    if snr is not None:
        snr_t = device_constant(("k8_snr_cols", snr.tobytes()), dev, lambda: snr, torch.int32)
    io = _SupIO(
        xa=xa.data_ptr(), xa_len=xa.shape[1], P=P.data_ptr(), p_clip=F * T, p_row=T,
        frame_class=frame_class.data_ptr(), noise_conf=noise_conf.data_ptr(),
        frame_idx=frame_idx.data_ptr(), tables=tables.data_ptr(),
        snr_cols=None if snr_t is None else snr_t.data_ptr(),
        tracker=cin[0].data_ptr(), scale=cin[1].data_ptr(), prev_n=cin[2].data_ptr(),
        wcount=cin[3].data_ptr(), rain_ema=cin[4].data_ptr(), is_first=cin[5].data_ptr(),
        g_prev=cin[6].data_ptr(), ola=cin[7].data_ptr(), y=y.data_ptr(),
        o_tracker=out[0].data_ptr(), o_scale=out[1].data_ptr(), o_prev_n=out[2].data_ptr(),
        o_wcount=out[3].data_ptr(), o_rain_ema=out[4].data_ptr(), o_is_first=out[5].data_ptr(),
        o_g_prev=out[6].data_ptr(), o_ola=out[7].data_ptr(), gain=gain.data_ptr(),
        taps=None if taps is None else taps.data_ptr(),
        chirp=None if chirp[0] is None else chirp[0].data_ptr(),
        chirp_bt=None if chirp[1] is None else chirp[1].data_ptr(),
        chirp_tab=None if chirp[2] is None else chirp[2].data_ptr(),
        walk_scratch=None if walk_scratch is None else walk_scratch.data_ptr(),
        walk_scratch_floats=0 if walk_scratch is None else walk_scratch.numel(),
        frame_scratch=None if frame_scratch is None else frame_scratch.data_ptr(),
        frame_scratch_bytes=0 if frame_scratch is None else 4 * frame_scratch.numel(),
    )
    lib = _kernels.build()
    with torch.cuda.device(dev):
        err = lib.lib.apt_streaming_suppressor(ctypes.addressof(io), ctypes.addressof(c),
                                               K8_ROUTES[route], _kernels.stream_of(xa))
    lib.check(err, "streaming_suppressor")
    _kernels.count("streaming_suppressor")
    lane, clip = trk.shape, wc.shape
    psd = (out[0].reshape(lane), out[1].reshape(lane), out[2].reshape(lane),
           out[3].reshape(clip), out[4].reshape(clip), out[5].view(torch.bool).reshape(clip))
    return y, (psd, out[6].reshape(lane), out[7].reshape(ola.shape)), gain if want_gain else None


def streaming_suppressor(sup: Suppressor, xa: torch.Tensor, P: torch.Tensor,
                         frame_class: torch.Tensor, noise_conf: torch.Tensor,
                         frame_idx: torch.Tensor, carry: SupCarry):
    """One chunk of the causal suppressor for B streams: ``xa`` (B, (T+1)
    hop) the carried samples and the chunk, ``P`` (B, F, T) the chunk's
    power, the frames' classes and noise confidence (B, T), the streams'
    frame counts (B,) and the carry ``(sup_psd, gain_prev, ola_tail)``.
    Returns ``(y, new_carry)``: kernel K8 on a CUDA tensor, its plain loop on
    a CPU tensor."""
    if xa.device.type == "cpu":
        y, carry, _ = _suppressor_plain(sup, xa, P, frame_class, noise_conf, frame_idx, carry)
    else:
        y, carry, _ = _suppressor_cuda(sup, xa, P, frame_class, noise_conf, frame_idx, carry)
    return y, carry


# ---------------------------------------------------------------------------
# The detector
# ---------------------------------------------------------------------------


def _seed_psd(carry, first_frame: torch.Tensor, eps: float):
    """A PSD carry whose streams have seen no frame yet takes its tracker and
    scale from this chunk's first band frame (``streaming.py:226-234``)."""
    trk, scl, pN, wc, rema, first = carry
    f0 = first[:, None]
    trk = torch.where(f0, torch.clamp(first_frame, min=0.0), trk)
    scl = torch.where(f0, torch.clamp(torch.abs(first_frame), min=float(max(eps, 1e-9))), scl)
    return trk, scl, pN, wc, rema, first


class StreamingRainDetector:
    """Causal chunked rain-frame detector with explicit state threading, on
    one device (the card unless the caller asks for the CPU)::

        det = StreamingRainDetector(device="cuda"); det.setup(params)
        state = det.init_state()
        for chunk in hop_multiple_chunks(stream):
            state, out = det.process_chunk(state, chunk)
    """

    def __init__(self, config: Optional[NoiseConfig] = None,
                 device: str | torch.device = "cuda"):
        self.cfg = config
        self.device = torch.device(device)
        self._is_setup = config is not None
        if self._is_setup:
            self.cfg.validate()
        self._st: Optional[_Static] = None
        self._sup: Optional[Suppressor] = None

    def setup(self, params: Dict[str, Any]) -> None:
        if self._is_setup:
            return
        sr = int(params.get("sample_rate", params.get("fs", 11162)))
        self.cfg = build_noise_config(sr, params)
        self.cfg.validate()
        self._is_setup = True

    # ------------------------------------------------------------------
    def _static(self) -> _Static:
        """Host constants of the configuration (``streaming.py:79-109``)."""
        if self._st is not None:
            return self._st
        cfg = self.cfg
        sr, n_fft, hop = cfg.fs, cfg.n_fft, cfg.hop
        freqs = fft_frequencies(sr, n_fft)
        op_lo, op_hi = cfg.operating_band
        band_rows = np.flatnonzero((freqs >= op_lo) & (freqs <= op_hi))
        if band_rows.size == 0:
            raise ValueError("operating_band does not overlap the frequency grid")
        freqs_band = freqs[band_rows]
        mode_bands = tuple((float(a), float(b)) for a, b in cfg.dget("mode_bands"))
        mode_masks = np.stack([(freqs_band >= lo) & (freqs_band <= hi) for lo, hi in mode_bands])
        K = band_rows.size
        L = max(1, int(mode_masks.sum(axis=1).max()))
        mode_index = np.full((mode_masks.shape[0], L), K, np.int64)
        for m, mask in enumerate(mode_masks):
            idx = np.flatnonzero(mask)
            mode_index[m, : idx.size] = idx
        fps = float(sr) / float(hop)
        psd_params = make_psd_params(
            cfg_q=cfg.q, win_sec=cfg.win_sec, frames_per_sec=fps,
            ema_up=cfg.ema_up, ema_down=cfg.ema_down, eps=cfg.eps,
            noise_psd_max_ratio=cfg.noise_psd_max_ratio,
            adaptive_q_enable=cfg.adaptive_q_enable,
            adaptive_q_min=cfg.adaptive_q_min,
            adaptive_q_alpha=cfg.adaptive_q_alpha,
        )
        td_mode = str(cfg.dget("td_prefilter_mode", cfg.dget("pre_filter_mode", "none"))).lower()
        td_sos = None
        if cfg.dflag("td_apply_input_prefilter", True) and td_mode not in ("", "none"):
            td_sos = build_prefilter_sos(cfg, sr, td_mode)
        self._st = _Static(sr, n_fft, hop, slice(int(band_rows[0]), int(band_rows[-1]) + 1),
                           mode_masks, mode_index, fps, psd_params, td_sos)
        if band_rows[-1] - band_rows[0] + 1 != K:
            raise ValueError("the operating band must be one run of spectrogram rows")
        return self._st

    # ------------------------------------------------------------------
    @property
    def emit_audio(self) -> bool:
        """True when chunks also return denoised audio (``y``)."""
        return bool(self.cfg.compute_output_audio)

    @property
    def audio_delay_samples(self) -> int:
        """Constant latency of the denoised audio against the input: the
        overlap-add finalizes a sample once every frame over it was seen,
        ``n_fft - hop`` samples (~11.5 ms at 256/128 and 11,162 Hz)."""
        return int(self.cfg.n_fft - self.cfg.hop)

    def _audio_static(self) -> _Audio:
        """Constants of the causal suppressor output (``streaming.py:125-154``)."""
        cfg = self.cfg
        if cfg.n_fft != 2 * cfg.hop:
            raise ValueError("streaming audio output requires 50% overlap (n_fft == "
                             f"2*hop); got n_fft={cfg.n_fft} hop={cfg.hop}")
        for knob in ("pre_smooth_frames", "median_frames"):
            if int(getattr(cfg, knob, 0) or 0) > 1:
                raise ValueError(f"streaming audio output does not support {knob} "
                                 "(acausal-window smoothing); clear it or use the offline engine")
        w = np.asarray(hann_window(cfg.n_fft), np.float64)
        hop = cfg.hop
        # steady-state weighted-OLA normalizer, applied as a reciprocal
        # multiply as the JAX package applies it
        ws = np.zeros(hop)
        for j in range(cfg.n_fft // hop):
            ws += w[j * hop : (j + 1) * hop] ** 2
        inv_ws = np.asarray(1.0 / ws, np.float32)
        inv_ws_tail = np.asarray(1.0 / np.maximum(w[hop:] ** 2, 1e-12), np.float32)
        snr_cols = None
        if bool(cfg.snr_gating_enable):
            K = self._static().rows.stop - self._static().rows.start
            mm = (self._static().mode_masks.any(axis=0) if bool(cfg.snr_gating_use_mode_bands)
                  else np.ones(K, bool))
            if not mm.any():
                mm = np.ones(K, bool)
            snr_cols = np.flatnonzero(mm)
        return _Audio(np.asarray(w, np.float32), inv_ws, inv_ws_tail, snr_cols)

    def suppressor(self) -> Suppressor:
        """The configuration's K8 constants (built once)."""
        if self._sup is None:
            self._sup = Suppressor(self.cfg, self._static(), self._audio_static())
        return self._sup

    # ------------------------------------------------------------------
    def init_state_batch(self, n_streams: int) -> State:
        """Fresh state of ``n_streams`` independent streams, every carry at
        its value before the first sample (``streaming.py:156-196``)."""
        cfg = self.cfg
        st = self._static()
        B, dev = int(n_streams), self.device
        K = st.rows.stop - st.rows.start
        n_modes = st.mode_masks.shape[0]
        tail = st.n_fft - st.hop
        floor = max(float(cfg.dget("mode_flux_norm_min", 1.0)), cfg.eps)

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros((B, *shape), dtype=dtype, device=dev)

        def psd():
            return (zeros(K), zeros(K), zeros(K), zeros(dtype=torch.int32), zeros(),
                    torch.ones(B, dtype=torch.bool, device=dev))

        def full(*shape):
            return torch.full((B, *shape), floor, dtype=torch.float32, device=dev)

        state: State = {
            "raw_tail": zeros(tail),
            "td_tail": zeros(tail),
            "frame_idx": zeros(dtype=torch.int32),
            "psd": psd(),
            "last_N": zeros(K),
            "pdet_tail": zeros(2, K),
            "mode_base": (full(n_modes), full(n_modes)),
            "all_base": (full(), full()),
        }
        if st.td_sos is not None:
            S = st.td_sos.shape[0]
            state["td_zi"] = zeros(S, 2, dtype=k7_state_dtype(st.td_sos))
        if self.emit_audio:
            self.suppressor()  # validates the configuration now
            state["sup_psd"] = psd()
            state["gain_prev"] = zeros(K)
            state["ola_tail"] = zeros(tail)
        return state

    def init_state(self) -> State:
        """Fresh state of one stream (a stream axis of 1)."""
        return self.init_state_batch(1)

    # ------------------------------------------------------------------
    def _chunk(self, state: State, x: torch.Tensor) -> Tuple[State, Dict[str, torch.Tensor]]:
        """One hop-multiple chunk of each of B streams (``streaming.py:199-438``)."""
        cfg = self.cfg
        st = self._static()
        n_fft, hop, rows = st.n_fft, st.hop, st.rows
        B, n = x.shape
        if n % hop != 0:
            raise ValueError(f"chunk length {n} must be a multiple of hop {hop}")
        if n == 0:
            raise ValueError("empty chunk: a chunk holds at least one hop of samples")
        T = n // hop
        dev = x.device
        eps = float(cfg.eps)
        tail = n_fft - hop
        new: State = {}

        # ---- causal power (K1) ----
        xa = torch.cat([state["raw_tail"], x], dim=1)
        P = spectrogram_power(xa, n_fft=n_fft, hop=hop, center=False)  # (B, F, T)
        new["raw_tail"] = xa[:, xa.shape[1] - tail:].contiguous()
        P_band = P[:, rows, :]  # (B, K, T), a view

        # ---- the detector's noise PSD (K2 with a carry) ----
        no_rain = torch.zeros((B, T), dtype=torch.bool, device=dev)
        N_band, new["psd"] = noise_psd_track_chunk(
            P_band, no_rain, _seed_psd(state["psd"], P_band[..., 0], cfg.eps), st.psd_params)
        gidx = state["frame_idx"][:, None] + torch.arange(T, device=dev, dtype=torch.int32)
        # lagged by one frame across the stream; the very first frame uses its own
        N_lag = torch.cat([state["last_N"][..., None], N_band[..., :-1]], dim=-1)
        N_lag = torch.where((gidx == 0)[:, None, :], N_band[..., :1], N_lag)
        maxr = float(np.clip(cfg.noise_psd_max_ratio, 0.0, 1.0))
        N_lag = torch.minimum(N_lag, maxr * P_band)
        new["last_N"] = N_band[..., -1].contiguous()
        P_det = 10.0 * torch.log10(P_band + eps) - 10.0 * torch.log10(N_lag + eps)

        # ---- t-vs-(t-2) positive flux, summed per mode in a fixed order ----
        hist = torch.cat([state["pdet_tail"].transpose(1, 2), P_det], dim=-1)  # (B, K, T + 2)
        d2 = torch.clamp(P_det - hist[..., :-2], min=0.0)
        d2 = torch.where((gidx >= 2)[:, None, :], d2, 0.0)  # global frames 0, 1: no flux
        new["pdet_tail"] = hist[..., -2:].transpose(1, 2).contiguous()
        d2z = torch.cat([d2, d2.new_zeros(B, 1, T)], dim=1)
        index = torch.as_tensor(st.mode_index, device=dev)
        mode_flux = tree_sum(d2z[:, index, :], dim=2)  # (B, n_modes, T)
        n_modes = mode_flux.shape[1]
        flux_all = mode_flux[:, 0]
        for m in range(1, n_modes):
            flux_all = flux_all + mode_flux[:, m]

        # ---- causal baselines of every mode and the sum: one K3 launch ----
        norm_min = max(float(cfg.dget("mode_flux_norm_min", 1.0)), eps)
        norm_q = float(np.clip(float(cfg.dget("mode_flux_norm_q", 20.0)), 0, 100))
        win_sec = float(cfg.dget("mode_flux_norm_win_sec", 0.5))
        (mb, ms), (ab, as_) = state["mode_base"], state["all_base"]
        base, (cb, cs) = causal_low_quantile_baseline_chunk(
            torch.cat([mode_flux, flux_all[:, None]], dim=1),
            (torch.cat([mb, ab[:, None]], dim=1), torch.cat([ms, as_[:, None]], dim=1)),
            q_percent=norm_q, samples_per_sec=st.fps, win_sec=win_sec, floor=norm_min)
        new["mode_base"] = (cb[:, :n_modes].contiguous(), cs[:, :n_modes].contiguous())
        new["all_base"] = (cb[:, n_modes].contiguous(), cs[:, n_modes].contiguous())
        base_m, base_a = base[:, :n_modes], base[:, n_modes]
        norm_flux = nan_to_num(torch.clamp(mode_flux - base_m, min=0.0) / (base_m + norm_min))
        score_all = nan_to_num(torch.clamp(flux_all - base_a, min=0.0) / (base_a + norm_min))

        # ---- TD gate: the causal prefilter (K7) ----
        if st.td_sos is not None:
            x_td, new["td_zi"] = sosfilt(st.td_sos, x, zi=state["td_zi"])
        else:
            x_td = x
        ta = torch.cat([state["td_tail"], x_td], dim=1)
        td_frames = frame_signal(ta, n_fft, hop)  # (B, T, n_fft)
        new["td_tail"] = ta[:, ta.shape[1] - tail:].contiguous()
        td_crest = nan_to_num(_crest_factor(td_frames, eps))
        td_kurt = _kurtosis(td_frames)
        td_kurt = nan_to_num(torch.where(torch.isfinite(td_kurt), td_kurt, 0.0))
        gate_mask = td_crest > float(cfg.dget("td_gate_threshold", 2.5))
        tk_up = cfg.dget("td_kurtosis_upper_threshold", None)
        if tk_up is not None:
            gate_mask = gate_mask & (td_kurt <= float(tk_up))
        gate = gate_mask.to(torch.float32)

        # ---- decision ----
        legacy12 = float(cfg.dget("new_rain_mode12_flux_min", 2.6))
        is_rain, rain_conf = rain_frame_decision(
            norm_flux[:, 0] * gate, norm_flux[:, 1] * gate, norm_flux[:, 2] * gate,
            norm_flux[:, 3] * gate,
            primary_flux_min=float(cfg.dget("new_rain_primary_flux_min", 1.8)),
            mode1_flux_min=float(cfg.dget("new_rain_mode1_flux_min", legacy12)),
            mode2_flux_min=float(cfg.dget("new_rain_mode2_flux_min", legacy12)),
            mode3_flux_min=float(cfg.dget("new_rain_mode3_flux_min", 3.0)),
            min_support_count=int(cfg.dget("new_rain_min_support_count", 2)),
        )
        noise_conf = torch.clamp(1.0 - rain_conf, 0.0, 1.0)
        weak = (score_all * gate) <= max(float(cfg.dget("mode_flux_noise_max", 1.5)), 0.0)
        noise_hi = float(cfg.dget("noise_hi", 0.80))
        frame_class = torch.where(
            is_rain, int(FrameClass.RAIN),
            torch.where((noise_conf >= noise_hi) & weak, int(FrameClass.NOISE),
                        int(FrameClass.UNCERTAIN))).to(torch.int8)

        # ---- causal suppressor output (K8) ----
        y = None
        if self.emit_audio:
            sup_psd = _seed_psd(state["sup_psd"], P_band[..., 0], cfg.eps)
            y, (new["sup_psd"], new["gain_prev"], new["ola_tail"]) = streaming_suppressor(
                self.suppressor(), xa, P, frame_class, noise_conf, state["frame_idx"],
                (sup_psd, state["gain_prev"], state["ola_tail"]))

        times = gidx.to(torch.float32) * (hop / float(st.sr))
        new["frame_idx"] = state["frame_idx"] + T
        out = {
            "frame_class": frame_class,
            "rain_conf": rain_conf,
            "noise_conf": noise_conf,
            "times": times,
            "td_crest_factor": td_crest,
            "td_kurtosis": td_kurt,
            "normalized_mode_flux_by_mode": norm_flux,
            "mode_flux_score": score_all,
            "noise_psd_band": N_band.transpose(1, 2),
        }
        if y is not None:
            out["y"] = y
        return {k: new[k] for k in sorted(state)}, sorted_keys(out)

    # ------------------------------------------------------------------
    def _as_batch(self, chunks) -> torch.Tensor:
        if isinstance(chunks, torch.Tensor):
            return chunks.to(torch.float32)
        return torch.as_tensor(np.asarray(chunks, np.float32), device=self.device)

    def process_chunk_batch(self, state: State, chunks) -> Tuple[State, Dict[str, torch.Tensor]]:
        """One chunk of each of B streams, ``chunks`` (B, L) with the same
        hop-multiple L (lockstep batching), on the device of the state;
        per stream, the bits of :meth:`process_chunk`.  Returns
        ``(new_state, outputs)`` with a leading stream axis."""
        x = self._as_batch(chunks)
        if x.dim() != 2:
            raise ValueError("chunks must be (n_streams, chunk_len)")
        if x.shape[0] != state["frame_idx"].shape[0]:
            raise ValueError(f"{x.shape[0]} chunks for a state of "
                             f"{state['frame_idx'].shape[0]} streams")
        return self._chunk(state, x)

    def process_chunk(self, state: State, chunk) -> Tuple[State, Dict[str, torch.Tensor]]:
        """One chunk (length a multiple of ``hop``) of one stream; the
        outputs have no stream axis."""
        x = self._as_batch(chunk).reshape(1, -1)
        state, out = self.process_chunk_batch(state, x)
        return state, {k: v[0] for k, v in out.items()}

    def drain_audio(self, state: State) -> np.ndarray:
        """The last ``n_fft - hop`` samples at stream end (best effort: only
        the last frame's window half covers them, so they are normalized by
        that partial window); (n_fft - hop,) for one stream, else (B, ...)."""
        if not self.emit_audio:
            raise ValueError("detector was not configured with compute_output_audio")
        tail = state["ola_tail"].cpu().numpy() * self._audio_static().inv_ws_tail
        return tail[0] if tail.shape[0] == 1 else tail

    def process_stream(self, x, chunk_sec: float = 2.0) -> Dict[str, np.ndarray]:
        """Convenience: a whole recording through fixed-size chunks."""
        hop = self.cfg.hop
        chunk_len = max(hop, int(self.cfg.fs * chunk_sec) // hop * hop)
        x = np.asarray(x, np.float32).reshape(-1)
        usable = x.size // hop * hop
        state = self.init_state()
        outs = []
        for start in range(0, usable, chunk_len):
            state, out = self.process_chunk(state, x[start : min(start + chunk_len, usable)])
            outs.append({k: v.cpu().numpy() for k, v in out.items()})
        axis = {"normalized_mode_flux_by_mode": 1, "noise_psd_band": 0}
        return {k: np.concatenate([o[k] for o in outs], axis=axis.get(k, -1)) for k in outs[0]}


# ---------------------------------------------------------------------------
# State across frameworks and connections
# ---------------------------------------------------------------------------


def _map_state(state, fn):
    return {k: tuple(fn(v) for v in leaf) if isinstance(leaf, tuple) else fn(leaf)
            for k, leaf in state.items()}


def state_from_jax(np_state: Dict[str, Any], device: str | torch.device = "cuda") -> State:
    """A JAX ``StreamingRainDetector`` state (NumPy leaves, one stream from
    ``init_state`` or a batch from ``init_state_batch``) as the port's state
    on ``device``, leaf for leaf: a stream begun in JAX goes on here."""
    single = np.ndim(np_state["frame_idx"]) == 0

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
    return {k: tuple(torch.cat([s[k][i] for s in states]) for i in range(len(first[k])))
            if isinstance(first[k], tuple) else torch.cat([s[k] for s in states])
            for k in first}


def split_state(state: State):
    """A batch state as per-stream states, each with a stream axis of 1."""
    B = state["frame_idx"].shape[0]
    return [_map_state(state, lambda v, i=i: v[i : i + 1]) for i in range(B)]
