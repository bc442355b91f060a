"""The port's own spans and counters in the traced segment.

The port's tracer (``audio_processing_tools_tpu_torch/utils/profiling.py``)
is on while the profiler runs.  Each of its spans leaves two empty marks on
the profiler's host timeline, at its start and its end, named with the
span's name and id.  :func:`segment` finds the marks that fall inside the
traced segment of a :class:`~harness.trace.Trace`, takes the tracer's report
of those spans only, and lays the spans over the card's idle gaps: a gap
counts for the innermost span open at its middle, as ``Trace.idle_gaps``
labels a gap by the host event at its middle.  A batch is one ``mesh.step``
span.  Where the port has no tracer, or the segment holds no ``mesh.step``
span, :func:`segment` gives None and the metrics that read it are left out.
The span table goes to standard error once a segment.
"""

from __future__ import annotations

import sys
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from harness.trace import SYNC_CALLS

STEP = "mesh.step"
#: spans of the mesh step itself; every other span inside it is the engine's
MESH = frozenset({"mesh.step", "mesh.shard", "mesh.split", "mesh.aggregates"})
_last: Tuple[Any, Optional["Segment"]] = (None, None)


class Segment:
    """The tracer's spans in one traced segment, on the profiler's clock."""

    def __init__(self, spans: Dict[int, Tuple[str, float, float]], report: Dict[str, Any],
                 host: List[Tuple[float, float, str]], gaps: Optional[List[Tuple[float, float]]]):
        self.spans = spans  # id -> (name, start us, end us)
        self.report = report
        steps = [(b, e) for name, b, e in spans.values() if name == STEP]
        self.batches = len(steps)
        #: host ms a batch inside ``mesh.step`` in each blocking call (a copy
        #: from pageable memory waits in the ``cudaStreamSynchronize`` after it)
        self.blocked_ms: Dict[str, float] = {}
        for s, t, n in host:
            if n in SYNC_CALLS:
                us = sum(max(0.0, min(t, e) - max(s, b)) for b, e in steps)
                self.blocked_ms[n] = self.blocked_ms.get(n, 0.0) + us * 1e-3 / self.batches
        #: host ms a batch inside ``mesh.step`` less its blocking calls
        self.dispatch_ms = (sum(e - b for b, e in steps) * 1e-3 / self.batches
                            - sum(self.blocked_ms.values()))
        #: the card's idle ms in the segment by the innermost open span at a
        #: gap's middle (None without device activity)
        self.idle_ms: Optional[Dict[str, float]] = None
        if gaps is not None:
            self.idle_ms = {}
            names = [v[0] for v in spans.values()]
            b = np.array([v[1] for v in spans.values()], np.float64)
            e = np.array([v[2] for v in spans.values()], np.float64)
            for g0, g1 in gaps:
                mid = 0.5 * (g0 + g1)
                inside = np.flatnonzero((b <= mid) & (e >= mid))
                if inside.size:
                    name = names[inside[np.argmax(b[inside])]]
                    self.idle_ms[name] = self.idle_ms.get(name, 0.0) + (g1 - g0) * 1e-3

    def per_batch(self, key: str) -> float:
        """``key`` (``syncs`` or ``launches``) inside ``mesh.step``, a batch."""
        return self.report["spans"][STEP][key] / self.batches

    def idle_ms_per_batch(self, engine: bool) -> Optional[float]:
        """Idle ms a batch under the mesh step's own spans, or under the
        engine's (``mesh.engine`` and the spans inside it)."""
        if self.idle_ms is None:
            return None
        return sum(ms for name, ms in self.idle_ms.items()
                   if (name not in MESH) == engine) / self.batches


def segment(ctx) -> Optional[Segment]:
    """The tracer's spans in ``ctx.trace``'s segment, computed once a trace."""
    global _last
    tr = getattr(ctx, "trace", None)
    if tr is None:
        return None
    if _last[0] is tr:
        return _last[1]
    seg = _read(tr)
    _last = (tr, seg)
    if seg is not None:
        print(table(seg), file=sys.stderr)
    return seg


def _read(tr) -> Optional[Segment]:
    try:
        from audio_processing_tools_tpu_torch.utils import profiling
    except ImportError:
        return None
    parse = getattr(profiling, "parse_mark", None)
    tracer = getattr(profiling, "TRACER", None)
    host = getattr(tr, "_host", None)
    if parse is None or tracer is None or not host:
        return None
    marks: Dict[int, Dict[bool, Any]] = {}
    for s, _, name in host:
        got = parse(name)
        if got is not None:
            is_start, span_name, sid = got
            marks.setdefault(sid, {"name": span_name})[is_start] = s
    spans = {sid: (m["name"], m[True], m[False]) for sid, m in marks.items()
             if True in m and False in m}
    if not any(name == STEP for name, _, _ in spans.values()):
        return None
    report = tracer.report([r for r in tracer.records if r.id in spans])
    gaps = None
    if tr.device_events:
        edges = [tr._lo] + [v for iv in tr._busy for v in iv] + [tr._hi]
        gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    return Segment(spans, report, host, gaps)


def table(seg: Segment) -> str:
    """The span table a batch, and the segment's top sync sites."""
    def f(v, digits=3):
        return "-" if v is None else f"{v:.{digits}f}"

    n = seg.batches
    idle = seg.idle_ms or {}
    lines = [f"spans: {n} batches ({STEP} spans); a batch: calls, host ms, self ms, "
             f"device ms, own syncs, own launches, idle ms",
             f"{'span':24s} {'calls':>6s} {'host':>9s} {'self':>9s} {'device':>9s} "
             f"{'syncs':>7s} {'launch':>7s} {'idle':>8s}"]
    for name, row in seg.report["spans"].items():
        pb = row["per_batch"]
        lines.append(f"{name:24s} {f(pb['calls'], 2):>6s} {f(pb['host_ms']):>9s} "
                     f"{f(pb['self_ms']):>9s} {f(pb['device_ms']):>9s} "
                     f"{f(pb['self_syncs'], 2):>7s} {f(pb['self_launches'], 2):>7s} "
                     f"{f(idle.get(name, 0.0) / n if seg.idle_ms is not None else None):>8s}")
    blocked = ", ".join(f"{call} {ms:.3f}" for call, ms in sorted(seg.blocked_ms.items()))
    lines.append(f"dispatch ms a batch {seg.dispatch_ms:.3f} (blocked: {blocked or 'none'}); "
                 f"sync sites (a batch):")
    for site, k in seg.report["sync_sites"][:12]:
        lines.append(f"  {k / n:7.2f}  {site}")
    return "\n".join(lines)
