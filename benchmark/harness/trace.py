"""The traced segment: ``torch.profiler`` over a few batches of the window's
loop, reduced to what the per-layer metrics and the breakdown read.

Device activity is every event the profiler puts on the card (kernels,
copies, sets); the busy time is the length of their union inside the
segment, so overlapping operations count once.  Host synchronisations are
the CUDA runtime calls that block the host.  An idle gap of the card is
labelled by what the host was doing at its middle: the harness span
(``bench.upload``, ``bench.step``, ``bench.readback``) and the innermost
host event inside it ("Python" where the host ran no traced operation).
The spans' own marks on the card's timeline are not device work.
"""

from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

#: CUDA runtime calls that block the host until the card catches up
SYNC_CALLS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                        "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D"})
#: device events that are copies or sets, not kernels
NOT_KERNEL = re.compile(r"^(Memcpy|Memset|memcpy|memset)")
SPAN = "bench.window"


def _short(name: str, width: int = 100) -> str:
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("(")[0][:width]


class Trace:
    """What one traced segment of ``batches`` batches holds."""

    def __init__(self, prof, batches: int):
        self.batches = batches
        events = list(prof.events())
        span = next(e for e in events if e.name == SPAN)
        lo, hi = span.time_range.start, span.time_range.end
        self.window_s = (hi - lo) * 1e-6
        dev, host = [], []
        for e in events:
            s, t = e.time_range.start, e.time_range.end
            if t < lo or s > hi:
                continue
            if e.device_type == torch.autograd.DeviceType.CUDA:
                if not e.name.startswith("bench."):  # the spans' own marks on the card
                    dev.append((max(s, lo), min(t, hi), e.name))
            elif e.thread == span.thread and e.name != SPAN:
                host.append((s, t, e.name))
        self.device_events = dev
        self.kernels = [(s, t, n) for s, t, n in dev if not NOT_KERNEL.match(n)]
        self.syncs = sum(1 for _, _, n in host if n in SYNC_CALLS)
        self._busy = _union(sorted((s, t) for s, t, _ in dev))
        self.busy_s = sum(t - s for s, t in self._busy) * 1e-6
        self._host = host
        self._lo, self._hi = lo, hi

    def kernel_seconds(self, pattern) -> float:
        return sum(t - s for s, t, n in self.kernels if pattern.search(n)) * 1e-6

    def device_ops(self, top: int = 10) -> List[Tuple[str, float]]:
        """The device operations that took most time, summed by name."""
        total: Dict[str, float] = defaultdict(float)
        for s, t, n in self.device_events:
            total[_short(n)] += (t - s) * 1e-6
        return sorted(total.items(), key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top: int = 10) -> List[Tuple[str, float]]:
        """The card's idle time inside the segment, summed by what the host
        was doing at each gap's middle; the largest sums."""
        edges = [self._lo] + [v for iv in self._busy for v in iv] + [self._hi]
        gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
        if not gaps:
            return []
        hs = np.array([h[0] for h in self._host], np.float64)
        he = np.array([h[1] for h in self._host], np.float64)
        names = [h[2] for h in self._host]
        total: Dict[str, float] = defaultdict(float)
        for a, b in gaps:
            mid = 0.5 * (a + b)
            inside = np.flatnonzero((hs <= mid) & (he >= mid))
            order = inside[np.argsort(hs[inside])]
            spans = [names[i] for i in order if names[i].startswith("bench.")]
            ops = [names[i] for i in order if not names[i].startswith("bench.")]
            label = (f"{spans[0] if spans else 'between batches'} > "
                     f"{_short(ops[-1], 80) if ops else 'Python'}")
            total[label] += (b - a) * 1e-6
        return sorted(total.items(), key=lambda kv: -kv[1])[:top]


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, t in intervals:
        if out and s <= out[-1][1]:
            if t > out[-1][1]:
                out[-1] = (out[-1][0], t)
        else:
            out.append((s, t))
    return out


def traced(fn, batches: int) -> Optional[Trace]:
    """Run ``fn(j)`` for ``j`` in ``range(batches)`` under the profiler."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(SPAN):
            for j in range(batches):
                fn(j)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    return Trace(prof, batches)
