"""Profiling / tracing.

Counterpart of ``audio_processing_tools_tpu/utils/profiling.py``: the
wall-clock helpers (``Timer``, ``timed``) as there, and ``device_trace``
on ``torch.profiler`` in place of ``jax.profiler``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Dict, Tuple


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a ``torch.profiler`` trace (host activity, and the card's
    kernels when a card is present), written as a Chrome trace
    (Perfetto-readable) into ``log_dir`` when the block ends.  Yields the
    profiler.

    Usage::

        with device_trace("traces"):
            engine.process_batch(xb)
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class Timer:
    """Named wall-clock section accumulator.

    The host-side twin of the per-processor ``latency_s`` instrumentation:
    collects named sections and reports totals/means.
    """

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_s": self.totals[name],
                "count": self.counts[name],
                "mean_s": self.totals[name] / max(self.counts[name], 1),
            }
            for name in self.totals
        }


def timed(func: Callable[..., Any], *args, **kwargs) -> Tuple[Any, float]:
    """(result, seconds) — the ``BaseProcessor._with_timing`` pattern."""
    t0 = time.perf_counter()
    result = func(*args, **kwargs)
    return result, time.perf_counter() - t0
