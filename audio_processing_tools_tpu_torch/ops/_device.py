"""Host constants kept resident on each device, and float32 scalars.

Filter and DFT constants are designed in NumPy on the host.  Copying them
to the card on every call would be a synchronous host-to-device copy each
time, so each is copied once per device and kept.  :func:`f32` and
:func:`f32_recip` make the 0-dim float32 constants that code matching the
JAX package's bits operates with.  :func:`sorted_keys` gives an output
dict the key order JAX's ``jit`` returns it in.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Hashable

import numpy as np
import torch

_CACHE: "OrderedDict[tuple, object]" = OrderedDict()
_CACHE_MAX = 64


def device_constant(key: Hashable, device: torch.device, make: Callable,
                    dtype: torch.dtype = torch.float32):
    """``make()`` (an array or a tuple of arrays) as tensors of ``dtype``
    (float32 unless asked) on ``device``, built once per (key, device) and
    kept in a small LRU."""
    full = (key, str(device))
    hit = _CACHE.get(full)
    if hit is not None:
        _CACHE.move_to_end(full)
        return hit
    value = make()
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    if isinstance(value, tuple):
        out = tuple(torch.as_tensor(np.asarray(v, np_dtype), device=device) for v in value)
    else:
        out = torch.as_tensor(np.asarray(value, np_dtype), device=device)
    _CACHE[full] = out
    while len(_CACHE) > _CACHE_MAX:
        _CACHE.popitem(last=False)
    return out


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


def sorted_keys(tree):
    """A nested dict with every level's keys in sorted order, the order in
    which JAX's ``jit`` returns a dict; other values are kept as they are."""
    if isinstance(tree, dict):
        return {k: sorted_keys(tree[k]) for k in sorted(tree)}
    return tree
