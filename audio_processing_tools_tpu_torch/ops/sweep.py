"""The spectral detector's decision rule over a grid of thresholds.

Counterpart of ``eval_combo`` in ``audio_processing_tools_tpu/tuning/
grid_search.py:231-241``, which the JAX package runs over every threshold
combo as one compiled program (``jax.jit(jax.vmap(eval_combo))``, ``:251``).
:func:`decision_counts` returns, for every combo c and clip b, the number
of frames the rule calls rain::

    gate    = td_crest > tdg_c
    f_k     = log1p(max(feat_k * gate, 0))      k = primary, s1, s2, s3
    hits    = [f_1 >= m1_c] + [f_2 >= m2_c] + [f_3 >= m3_c]
    is_rain = [f_0 >= pm_c] & [hits >= msc_c]
    count   = sum over frames of is_rain

The clip prediction ``count >= max(1, clip_rain_min_frames)`` is one
comparison on the (C, B) counts, left to the caller.  On a CUDA tensor the
counts come from kernel K10 (``csrc/sweep.cu``), which takes the log planes
``log1p(max(feat_k, 0))`` computed here with torch and only compares and
counts; on a CPU tensor from :func:`_decision_counts_plain`, the JAX
expression written out over a combo axis.  Both give the same integers.
The rule is only ever scored, so there is no gradient.

K10 counts bit-sliced.  :func:`k10_tables` cuts the combos into slices
and finds, per slice and flux axis, the distinct (gate threshold, flux
threshold) pairs by bit pattern and each combo's row among them, with a
fixed number of NumPy operations on the host whatever the number of combos
(the thresholds are copied from the card once); :func:`k10_plan` picks the
largest slice that still gives the card enough blocks and whose pairs fit
the shared memory a block aims at.  The kernel turns each pair into frame
bitmasks once and counts every combo with word logic and popcounts.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from audio_processing_tools_tpu_torch import _kernels

FEATURES = ("primary", "s1", "s2", "s3", "td_crest")
PLAIN_CHUNK_BYTES = 256 * 2**20  # one (chunk, B, T) float32 plane of the plain version
K10_SMEM_BYTES = 232448  # csrc/sweep.cu: shared memory a block may hold (227 KB)
K10_SLICE_BYTES = 48 * 1024  # shared memory a K10 block aims at: four blocks an SM
K10_TARGET_BLOCKS = 132  # K10 blocks a launch aims at: one an SM of an H100
K10_MAX_FRAMES = 14432  # the most frames at which 32 combos with distinct pairs fit a block

class SweepParams(NamedTuple):
    """One value per combo: the four flux thresholds and the TD gate as
    float32, the support count as int32 (all (C,), on the features' device)."""
    primary_flux_min: torch.Tensor
    mode1_flux_min: torch.Tensor
    mode2_flux_min: torch.Tensor
    mode3_flux_min: torch.Tensor
    min_support_count: torch.Tensor
    td_gate_threshold: torch.Tensor


def sweep_params(pm, m1, m2, m3, msc, tdg, device) -> SweepParams:
    """:class:`SweepParams` from per-combo sequences: every threshold as
    float32 (a float64 value is rounded once, as JAX does with x64 off), the
    support count as int32."""
    def f(v):
        return torch.as_tensor(v, dtype=torch.float32).to(device).reshape(-1)

    return SweepParams(f(pm), f(m1), f(m2), f(m3),
                       torch.as_tensor(msc, dtype=torch.int32).to(device).reshape(-1), f(tdg))


def _check(feats: Dict[str, torch.Tensor], params: SweepParams):
    crest = feats["td_crest"]
    dev, shape = crest.device, tuple(crest.shape)
    for k in FEATURES:
        t = feats[k]
        if t.device != dev or tuple(t.shape) != shape or t.dim() != 2 or t.dtype != torch.float32:
            raise ValueError(f"decision_counts: feature {k} is {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}; expected float32 {shape} (B, T) on {dev}")
    C = params.primary_flux_min.shape[0]
    for name, t in params._asdict().items():
        want = torch.int32 if name == "min_support_count" else torch.float32
        if t.device != dev or tuple(t.shape) != (C,) or t.dtype != want:
            raise ValueError(f"decision_counts: {name} is {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}; expected {want} ({C},) on {dev}")
    return dev, shape, C


def _decision_counts_plain(feats: Dict[str, torch.Tensor], params: SweepParams) -> torch.Tensor:
    """``eval_combo``'s expression as written, broadcast over a combo axis
    in chunks whose (chunk, B, T) float32 plane stays under 256 MB; (C, B)
    int32 counts."""
    B, T = feats["td_crest"].shape
    C = params.primary_flux_min.shape[0]
    chunk = max(1, PLAIN_CHUNK_BYTES // max(4 * B * T, 1))
    out = []
    for lo in range(0, C, chunk):
        sl = slice(lo, min(lo + chunk, C))

        def col(t):
            return t[sl, None, None]

        gate = (feats["td_crest"][None] > col(params.td_gate_threshold)).to(torch.float32)
        f = [torch.log1p(torch.clamp_min(feats[k][None] * gate, 0.0))
             for k in ("primary", "s1", "s2", "s3")]
        hits = ((f[1] >= col(params.mode1_flux_min)).to(torch.int32)
                + (f[2] >= col(params.mode2_flux_min)).to(torch.int32)
                + (f[3] >= col(params.mode3_flux_min)).to(torch.int32))
        is_rain = (f[0] >= col(params.primary_flux_min)) & (hits >= col(params.min_support_count))
        out.append(is_rain.sum(-1, dtype=torch.int32))
    if not out:
        return torch.zeros((0, B), dtype=torch.int32, device=feats["td_crest"].device)
    return torch.cat(out)


def log_planes(feats: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``log1p(max(feat_k, 0))`` of the four flux planes, stacked (4, B, T):
    the values the rule compares where the TD gate is open."""
    return torch.stack([torch.log1p(torch.clamp_min(feats[k], 0.0))
                        for k in ("primary", "s1", "s2", "s3")]).contiguous()


def _k10_row_bytes(T: int) -> int:
    """Shared bytes a pair of a K10 slice takes at ``T`` frames: a mask row of
    ``ceil(T / 32) | 1`` words and its (gate, flux) thresholds
    (``csrc/sweep.cu::shared_bytes``)."""
    return 4 * ((-(-T // 32)) | 1) + 8


def _k10_keys(thr: np.ndarray) -> np.ndarray:
    """(4, C) uint64: each combo's (td gate, flux threshold) bit patterns on
    the four flux axes, the gate's in the high word."""
    bits = np.ascontiguousarray(thr, np.float32).view(np.uint32).T.astype(np.uint64)
    return (bits[4:5] << np.uint64(32)) | bits[:4]


def k10_tables(thr: np.ndarray, S: int):
    """K10's pair tables for slices of ``S`` combos (the last one padded
    with the last combo), from ``thr`` (C, 5) float32: pm, m1, m2, m3, tdg.

    * ``rows`` (n_slices, P, 2) float32: a slice's distinct (td gate, flux
      threshold) pairs, axis after axis (pm, m1, m2, m3), then zeros; P is
      the most rows a slice has;
    * ``offs`` (n_slices, 5) int32: where each axis's rows start, and the
      slice's row count;
    * ``index`` (n_slices * S, 4) int32: each combo's row on each axis.

    Pairs are told apart by their bit patterns, so a NaN threshold stays
    itself and -0 and +0 are two pairs (which compare alike).  Per slice and
    axis the keys are sorted, their first occurrences numbered by a
    cumulative sum, and the numbers put back to the combos.
    """
    C = thr.shape[0]
    n_slices = -(-C // S)
    keys = _k10_keys(thr)[:, np.minimum(np.arange(n_slices * S), C - 1)]
    keys = np.ascontiguousarray(keys.reshape(4, n_slices, S).transpose(1, 0, 2))
    order = np.argsort(keys, axis=-1)
    sorted_keys = np.take_along_axis(keys, order, -1)
    first = np.ones(keys.shape, bool)
    first[..., 1:] = sorted_keys[..., 1:] != sorted_keys[..., :-1]
    rank = np.cumsum(first, -1) - 1
    offs = np.zeros((n_slices, 5), np.int64)
    offs[:, 1:] = np.cumsum(rank[..., -1] + 1, -1)
    index = np.empty_like(rank)
    np.put_along_axis(index, order, rank + offs[:, :4, None], -1)
    rows = np.zeros((n_slices, int(offs[:, 4].max()), 2), np.uint32)
    sl, ax, _ = np.nonzero(first)
    at = offs[sl, ax] + rank[first]
    rows[sl, at, 0] = (sorted_keys[first] >> np.uint64(32)).astype(np.uint32)
    rows[sl, at, 1] = (sorted_keys[first] & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return (rows.view(np.float32), offs.astype(np.int32),
            index.transpose(0, 2, 1).reshape(n_slices * S, 4).astype(np.int32))


def k10_plan(thr: np.ndarray, T: int, B: int):
    """``(S, k10_tables(thr, S))``: the largest power-of-two slice (at most
    the number of combos) that gives at least :data:`K10_TARGET_BLOCKS`
    blocks over ``B`` clips and whose pairs fit :data:`K10_SLICE_BYTES` of
    shared memory at ``T`` frames, halved until they do (a slice of one
    combo, four rows, always fits up to :data:`K10_MAX_FRAMES`).  A slice's
    row count at any size comes from each combo's previous combo with the
    same pair: a combo adds a row where that one lies before its slice."""
    C = thr.shape[0]
    S = 1
    while 2 * S <= C and -(-C // (2 * S)) * B >= K10_TARGET_BLOCKS:
        S *= 2
    keys = _k10_keys(thr)
    order = np.argsort(keys, axis=-1, kind="stable")
    sorted_keys = np.take_along_axis(keys, order, -1)
    prev = np.full(keys.shape, -1, np.int64)  # the combo before with the same pair, or -1
    same = sorted_keys[:, 1:] == sorted_keys[:, :-1]
    np.put_along_axis(prev, order[:, 1:], np.where(same, order[:, :-1], -1), -1)
    combo = np.arange(C)
    while S > 1:
        new_row = prev < combo // S * S
        most = np.bincount(np.nonzero(new_row)[1] // S, minlength=-(-C // S)).max()
        if most * _k10_row_bytes(T) <= K10_SLICE_BYTES:
            break
        S //= 2
    return S, k10_tables(thr, S)


def k10_operands(feats: Dict[str, torch.Tensor], params: SweepParams):
    """K10's operands: the log planes (4, B, T), the TD crest (B, T), the
    slice size S, :func:`k10_plan`'s tables on the features' device (one
    copy to the card), and the support counts (C,) int32, each contiguous.
    The thresholds are copied to the host for the tables (one
    synchronisation)."""
    crest = feats["td_crest"].contiguous()
    B, T = crest.shape
    logs = log_planes(feats)
    msc = params.min_support_count.contiguous()
    if msc.shape[0] == 0:
        return logs, crest, 1, None, None, None, msc
    thr = torch.stack([params.primary_flux_min, params.mode1_flux_min, params.mode2_flux_min,
                       params.mode3_flux_min, params.td_gate_threshold], 1).cpu().numpy()
    S, (rows, offs, index) = k10_plan(thr, T, max(B, 1))
    # one int32 buffer: the index (int4 loads), then the rows (float2 loads),
    # each at a multiple of 4 words, then the offsets
    parts = (index, rows.view(np.int32), offs)
    buf = torch.from_numpy(np.concatenate([p.reshape(-1) for p in parts])).to(crest.device)
    at = np.cumsum([0] + [p.size for p in parts])
    index_d, rows_d, offs_d = (buf[a:b].view(p.shape) for a, b, p in zip(at, at[1:], parts))
    return logs, crest, S, rows_d.view(torch.float32), offs_d, index_d, msc


def _launch_k10(logs: torch.Tensor, crest: torch.Tensor, S: int, rows, offs, index,
                msc: torch.Tensor) -> torch.Tensor:
    """One launch of K10 (``csrc/sweep.cu``) on :func:`k10_operands`: one
    block per (slice of S combos, clip) builds its pair masks in shared
    memory and counts the slice's combos.  Returns the (C, B) int32
    counts."""
    B, T = crest.shape
    C = msc.shape[0]
    _kernels.require_cuda("decision_counts(td_crest)", crest, torch.float32, 2)
    _kernels.require_cuda("decision_counts(log planes)", logs, torch.float32, 3)
    _kernels.require_cuda("decision_counts(support counts)", msc, torch.int32, 1)
    if tuple(logs.shape) != (4, B, T):
        raise ValueError(f"decision_counts: log planes {tuple(logs.shape)} do not fit crest "
                         f"{tuple(crest.shape)}")
    if T > K10_MAX_FRAMES:
        raise ValueError(f"decision_counts: the CUDA kernel takes at most {K10_MAX_FRAMES} "
                         f"frames a clip; got {T}")
    if B > 65535:
        raise ValueError(f"decision_counts: the CUDA kernel takes at most 65,535 clips; got {B}")
    counts = torch.empty((C, B), dtype=torch.int32, device=crest.device)
    if C == 0 or B == 0:
        return counts
    if T == 0:
        return counts.zero_()
    n_slices = -(-C // S)
    _kernels.require_cuda("decision_counts(pair rows)", rows, torch.float32, 3)
    _kernels.require_cuda("decision_counts(row offsets)", offs, torch.int32, 2)
    _kernels.require_cuda("decision_counts(pair index)", index, torch.int32, 2)
    P = rows.shape[1]
    if (tuple(rows.shape) != (n_slices, P, 2) or tuple(offs.shape) != (n_slices, 5)
            or tuple(index.shape) != (n_slices * S, 4)):
        raise ValueError(f"decision_counts: pair tables {tuple(rows.shape)}, "
                         f"{tuple(offs.shape)}, {tuple(index.shape)} do not fit {C} combos "
                         f"in slices of {S}")
    if P * _k10_row_bytes(T) > K10_SMEM_BYTES:
        raise ValueError(f"decision_counts: {P} pair rows of {T} frames do not fit a block's "
                         f"shared memory")
    lib = _kernels.build()
    with torch.cuda.device(crest.device):
        err = lib.lib.apt_decision_sweep(logs.data_ptr(), crest.data_ptr(), rows.data_ptr(),
                                         offs.data_ptr(), index.data_ptr(), msc.data_ptr(),
                                         counts.data_ptr(), B, T, C, S, P,
                                         _kernels.stream_of(crest))
    lib.check(err, "decision_sweep")
    _kernels.count("decision_sweep")
    return counts


def _decision_counts_cuda(feats: Dict[str, torch.Tensor], params: SweepParams) -> torch.Tensor:
    """K10 on the log planes this wrapper computes with torch."""
    return _launch_k10(*k10_operands(feats, params))


def decision_counts(feats: Dict[str, torch.Tensor], params: SweepParams) -> torch.Tensor:
    """Rain-frame counts (C, B) int32 of the decision rule for every combo
    of ``params`` on every clip of ``feats`` (``primary``, ``s1``, ``s2``,
    ``s3``, ``td_crest``: float32 (B, T) on one device).  Kernel K10 on a
    CUDA tensor, the plain version on a CPU tensor; the same integers."""
    dev, _, _ = _check(feats, params)
    if dev.type == "cpu":
        return _decision_counts_plain(feats, params)
    return _decision_counts_cuda(feats, params)
