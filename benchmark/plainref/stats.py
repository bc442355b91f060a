"""Statistical primitives, batched.

Counterpart of ``audio_processing_tools_tpu/ops/stats.py:17-132``:
``crest_factor`` and ``nan_to_num``; and :func:`tree_sum`, a sum in one
fixed order on every device and at every shape.
"""

from __future__ import annotations

import torch
import torch.nn.functional as tnf


def crest_factor(x: torch.Tensor, dim: int, eps: float) -> torch.Tensor:
    """Peak-to-RMS ratio, ``eps`` inside the root (``stats.py:39-52``)."""
    peak = torch.amax(torch.abs(x), dim=dim)
    msq = torch.mean(x * x, dim=dim)
    rms = torch.sqrt(msq + eps)
    return peak / torch.clamp(rms, min=eps)


def nan_to_num(x: torch.Tensor) -> torch.Tensor:
    """``np.nan_to_num`` with every replacement 0."""
    return torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)


def tree_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum over ``dim`` in one fixed pairwise order: zero-padded to a power of
    two ``m``, then ``x[i] + x[i + m/2]`` level by level.  Each level is an
    elementwise addition, so the bits do not depend on the device, the
    other dimensions' sizes or the library's reduction strategy (torch's
    reductions change their order with the shape, on the card with the
    number of outputs)."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    m = 1 << max(0, (n - 1).bit_length())
    if m != n:
        x = tnf.pad(x, (0, m - n))
    while m > 1:
        m //= 2
        x = x[..., :m] + x[..., m:]
    return x[..., 0]
