"""Local maxima along the last axis as a fixed-shape mask, plain PyTorch.

Frozen copy of the port's ``ops/peaks.py`` CPU path of :func:`local_maxima`,
the JAX package's own form (``torch.cummax`` for ``lax.cummax``).
"""

from __future__ import annotations

import torch


def local_maxima(x: torch.Tensor) -> torch.Tensor:
    """Boolean mask of local maxima along the last axis (at least 3 long),
    scipy's plateau rule included: a plateau marks its midpoint; the first
    and last samples never peak.  Each position finds the nearest strict
    change on each side with a running max over encoded boundary indices
    whose low bit carries the change's direction (the port's kernel K11
    gives the same mask)."""
    n = x.shape[-1]

    # boundary j sits between samples j and j+1 (j = 0..n-2)
    chg = x[..., 1:] != x[..., :-1]
    up = (x[..., 1:] > x[..., :-1]).to(torch.int64)
    fall = (x[..., 1:] < x[..., :-1]).to(torch.int64)
    idx = torch.arange(n - 1, device=x.device)
    neg1 = torch.full(x.shape[:-1] + (1,), -1, dtype=torch.int64, device=x.device)

    # last change boundary j <= m-1, encoded j*2 + up
    enc_l = torch.where(chg, idx * 2 + up, -1)
    pos_enc = torch.cat([neg1, torch.cummax(enc_l, dim=-1).values], dim=-1)
    has_l = pos_enc >= 0
    s = torch.where(has_l, (pos_enc >> 1) + 1, 0)  # plateau start
    left_rise = has_l & ((pos_enc & 1) == 1)

    # next change boundary j >= m, encoded with the reversed index so the
    # running max from the right picks the smallest j
    enc_r = torch.where(chg, (n - 2 - idx) * 2 + fall, -1)
    rmax = torch.cummax(enc_r.flip(-1), dim=-1).values.flip(-1)
    nxt_enc = torch.cat([rmax, neg1], dim=-1)
    has_r = nxt_enc >= 0
    e = torch.where(has_r, (n - 2) - (nxt_enc >> 1), n - 1)  # plateau end
    right_fall = has_r & ((nxt_enc & 1) == 1)

    m = torch.arange(n, device=x.device)
    return left_rise & right_fall & (m == torch.div(s + e, 2, rounding_mode="floor"))
