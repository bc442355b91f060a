"""Strided framing (``audio_processing_tools_tpu/ops/framing.py:16-60``).

The JAX package frames with reshapes and gathers because JAX has no strided
views; ``Tensor.unfold`` is one, so framing here copies nothing.
"""

from __future__ import annotations

import torch


def num_frames(n_samples: int, frame_len: int, hop: int) -> int:
    """Number of complete non-centered frames, ``1 + (n - frame_len) // hop``
    (0 when the signal is shorter than one frame)."""
    if n_samples < frame_len:
        return 0
    return 1 + (n_samples - frame_len) // hop


def frame_signal(x: torch.Tensor, frame_len: int, hop: int) -> torch.Tensor:
    """Frame the last axis: ``(..., n) -> (..., T, frame_len)`` as a view,
    ``T = 1 + (n - frame_len) // hop``."""
    t = num_frames(x.shape[-1], frame_len, hop)
    if t == 0:
        return x.new_zeros(x.shape[:-1] + (0, frame_len))
    return x.unfold(-1, frame_len, hop)
