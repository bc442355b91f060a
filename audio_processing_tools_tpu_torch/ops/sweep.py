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
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from audio_processing_tools_tpu_torch import _kernels

FEATURES = ("primary", "s1", "s2", "s3", "td_crest")
PLAIN_CHUNK_BYTES = 256 * 2**20  # one (chunk, B, T) float32 plane of the plain version
K10_MAX_FRAMES = 232448 // 20  # csrc/sweep.cu: five float32 planes a clip in 227 KB


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


def k10_operands(feats: Dict[str, torch.Tensor], params: SweepParams):
    """K10's operands: the log planes (4, B, T), the TD crest (B, T), the
    float thresholds (C, 5) as pm, m1, m2, m3, tdg, and the support counts
    (C,) int32, each contiguous."""
    thr = torch.stack([params.primary_flux_min, params.mode1_flux_min, params.mode2_flux_min,
                       params.mode3_flux_min, params.td_gate_threshold], dim=1).contiguous()
    return (log_planes(feats), feats["td_crest"].contiguous(), thr,
            params.min_support_count.contiguous())


def _launch_k10(logs: torch.Tensor, crest: torch.Tensor, thr: torch.Tensor,
                msc: torch.Tensor) -> torch.Tensor:
    """One launch of K10 (``csrc/sweep.cu``) on :func:`k10_operands`:
    one 256-thread block per clip and slice of 256 combos, the clip's
    planes staged in shared memory.  Returns the (C, B) int32 counts."""
    B, T = crest.shape
    C = thr.shape[0]
    _kernels.require_cuda("decision_counts(td_crest)", crest, torch.float32, 2)
    _kernels.require_cuda("decision_counts(log planes)", logs, torch.float32, 3)
    _kernels.require_cuda("decision_counts(thresholds)", thr, torch.float32, 2)
    _kernels.require_cuda("decision_counts(support counts)", msc, torch.int32, 1)
    if tuple(logs.shape) != (4, B, T) or tuple(thr.shape) != (C, 5) or msc.shape[0] != C:
        raise ValueError(f"decision_counts: operands {tuple(logs.shape)}, {tuple(thr.shape)}, "
                         f"{tuple(msc.shape)} do not fit crest {tuple(crest.shape)}")
    if T > K10_MAX_FRAMES:
        raise ValueError(f"decision_counts: the CUDA kernel stages at most {K10_MAX_FRAMES} "
                         f"frames a clip in shared memory; got {T}")
    counts = torch.empty((C, B), dtype=torch.int32, device=crest.device)
    if C == 0 or B == 0:
        return counts
    if T == 0:
        return counts.zero_()
    lib = _kernels.build()
    with torch.cuda.device(crest.device):
        err = lib.lib.apt_decision_sweep(logs.data_ptr(), crest.data_ptr(), thr.data_ptr(),
                                         msc.data_ptr(), counts.data_ptr(), B, T, C,
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
