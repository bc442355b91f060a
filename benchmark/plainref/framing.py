"""Strided framing (``audio_processing_tools_tpu/ops/framing.py:16-60``).

The JAX package frames with reshapes and gathers because JAX has no strided
views; ``Tensor.unfold`` is one, so framing here copies nothing.
"""

from __future__ import annotations

import torch


def frame_signal(x: torch.Tensor, frame_len: int, hop: int) -> torch.Tensor:
    """Frame the last axis (at least ``frame_len`` long): ``(..., n) ->
    (..., T, frame_len)`` as a view, ``T = 1 + (n - frame_len) // hop``."""
    return x.unfold(-1, frame_len, hop)
