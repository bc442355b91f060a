"""Host constants as float32 tensors, and float32 scalars.

:func:`f32` and :func:`f32_recip` make the 0-dim float32 constants that
code matching the JAX package's bits operates with.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def host(make: Callable):
    """``make()`` (an array or a tuple of arrays) as float32 tensors."""
    value = make()
    if isinstance(value, tuple):
        return tuple(torch.as_tensor(np.asarray(v, np.float32)) for v in value)
    return torch.as_tensor(np.asarray(value, np.float32))


def f32(value, device) -> torch.Tensor:
    """A Python constant rounded to float32, as a 0-dim tensor on ``device``
    (what JAX does with a weakly typed Python float)."""
    return torch.tensor(np.float32(value), device=device)


def f32_recip(value, device, times=1.0) -> torch.Tensor:
    """``times * (1 / value)`` in float32, as a 0-dim tensor on ``device``:
    compiled, XLA multiplies by it where JAX computes ``x * times / value``
    with constants ``times`` and ``value`` (``jnp.mean`` included), and a
    product gives the same bits on the CPU and the card."""
    return torch.tensor(np.float32(times) * (np.float32(1) / np.float32(value)), device=device)
