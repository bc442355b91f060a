"""Statistical primitives with scipy/numpy-parity semantics, batched.

Counterpart of ``audio_processing_tools_tpu/ops/stats.py:17-132``:
``kurtosis`` (scipy parity), ``crest_factor``, ``quantile_linear`` (NumPy's
default linear interpolation) and ``nan_to_num``.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def kurtosis(x: torch.Tensor, dim: int = -1, fisher: bool = True,
             bias: bool = True) -> torch.Tensor:
    """``scipy.stats.kurtosis`` parity (``stats.py:17-36``)."""
    x = x.to(torch.float32)
    n = x.shape[dim]
    mean = torch.mean(x, dim=dim, keepdim=True)
    d = x - mean
    m2 = torch.mean(d * d, dim=dim)
    m4 = torch.mean((d * d) * (d * d), dim=dim)
    pos = m2 > 0
    g2 = m4 / torch.where(pos, m2 * m2, 1.0) - 3.0
    g2 = torch.where(pos, g2, -3.0 if fisher else 0.0)
    if not bias:
        if n < 4:
            out = torch.full(g2.shape, math.nan, dtype=torch.float32, device=x.device)
            return out if fisher else out + 3.0
        nf = float(n)
        G2 = ((nf + 1.0) * g2 + 6.0) * (nf - 1.0) / ((nf - 2.0) * (nf - 3.0))
        g2 = torch.where(pos, G2, -3.0)
    return g2 if fisher else g2 + 3.0


def crest_factor(x: torch.Tensor, dim: int = -1, eps: float = 1e-9,
                 eps_in_rms: bool = True) -> torch.Tensor:
    """Peak-to-RMS ratio (``stats.py:39-52``)."""
    peak = torch.amax(torch.abs(x), dim=dim)
    msq = torch.mean(x * x, dim=dim)
    if eps_in_rms:
        rms = torch.sqrt(msq + eps)
        return peak / torch.clamp(rms, min=eps)
    return peak / (torch.sqrt(msq) + 1e-12)


def quantile_linear(x: torch.Tensor, q: float, dim: int = -1) -> torch.Tensor:
    """``np.quantile`` with linear interpolation along ``dim``
    (``stats.py:121-123``: sort, then interpolate the two order statistics
    around ``q * (n - 1)``)."""
    xs = torch.sort(x.movedim(dim, -1), dim=-1).values
    n = xs.shape[-1]
    if n == 0:
        return xs.new_zeros(xs.shape[:-1])
    h = np.float32(q) * np.float32(n - 1)  # float32, as the JAX package computes it
    lo, hi = int(np.floor(h)), int(np.ceil(h))
    v_lo = xs[..., lo]
    v_hi = xs[..., hi]
    return v_lo + float(h - np.float32(lo)) * (v_hi - v_lo)


def nan_to_num(x: torch.Tensor, nan: float = 0.0, posinf: float = 0.0,
               neginf: float = 0.0) -> torch.Tensor:
    """``np.nan_to_num`` with explicit replacements (all 0 by default)."""
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)
