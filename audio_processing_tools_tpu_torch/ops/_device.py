"""Host constants kept resident on each device.

Filter and DFT constants are designed in NumPy on the host.  Copying them
to the card on every call would be a synchronous host-to-device copy each
time, so each is copied once per device and kept.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Hashable

import numpy as np
import torch

_CACHE: "OrderedDict[tuple, object]" = OrderedDict()
_CACHE_MAX = 64


def device_constant(key: Hashable, device: torch.device, make: Callable):
    """``make()`` (an array or a tuple of arrays) as float32 tensors on
    ``device``, built once per (key, device) and kept in a small LRU."""
    full = (key, str(device))
    hit = _CACHE.get(full)
    if hit is not None:
        _CACHE.move_to_end(full)
        return hit
    value = make()
    if isinstance(value, tuple):
        out = tuple(torch.as_tensor(np.asarray(v, np.float32), device=device) for v in value)
    else:
        out = torch.as_tensor(np.asarray(value, np.float32), device=device)
    _CACHE[full] = out
    while len(_CACHE) > _CACHE_MAX:
        _CACHE.popitem(last=False)
    return out
