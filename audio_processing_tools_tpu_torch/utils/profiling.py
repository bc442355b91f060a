"""Profiling and tracing of the port.

The tracer (:data:`TRACER`, driven through :func:`span`, :func:`count`,
:func:`tracing` and :func:`report`) records spans at the port's layer
boundaries and counters inside them.  It is on while a ``torch.profiler``
session runs (torch's own flag, ``torch.autograd.profiler._is_profiler_enabled``)
and inside a :func:`tracing` block.  Off, :func:`span` is one flag test that
returns a shared no-op context and :func:`count` one test of the open-span
stack: nothing is allocated and no CUDA call is made.

On, a span records its name, id, parent, host start and end
(``time.perf_counter_ns``) and, once CUDA is up, a pair of CUDA events on
the current stream from a pool, resolved only by :func:`report`.  Counters
(:func:`count`) go to the innermost open span; two are the tracer's own:
``launches``, one for each launch of the port's hand kernels
(``_kernels.count``), and ``syncs``, the
blocking CUDA calls that ``torch.cuda.set_sync_debug_mode("warn")`` reports
while a span is open, each also put down to the port's ``file:line`` that
made it.  Records are kept up to :attr:`Tracer.max_records`; past that the
oldest are dropped and counted.  Spans follow one thread: while a span is
open, spans, counts and syncs on other threads (a thread pool running
engines) are not recorded.

While a profiler session runs, each span also leaves two empty
``record_function`` marks on the profiler's host timeline, ``apt>name#id``
at its start and ``apt<name#id`` at its end (:func:`parse_mark`).  Wrapping
no work, they put nothing on the card's timeline, and a reader of the trace
lays the spans over the card's idle gaps with them.

:func:`device_trace` is the exporter: a Chrome trace and the span table
(:func:`report`) as JSON beside it.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import sys
import threading
import time
import warnings
from collections import deque
from typing import Any, Deque, Dict, Iterable, List, Optional, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler

#: the port's package directory: a sync is put down to the innermost frame
#: under it
PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__))) + os.sep
#: the start of the warning ``set_sync_debug_mode("warn")`` gives a blocking call
SYNC_WARNING = "called a synchronizing CUDA operation"
#: the span that is one batch of the backfill step; the report's per-batch base
BATCH_SPAN = "mesh.step"
_MARK = re.compile(r"^apt([<>])(.+)#(\d+)$")


def parse_mark(name: str) -> Optional[Tuple[bool, str, int]]:
    """``(is_start, span name, span id)`` of a span's boundary mark on the
    profiler's timeline, None for any other event name."""
    m = _MARK.match(name)
    return None if m is None else (m.group(1) == ">", m.group(2), int(m.group(3)))


def _mark(name: str) -> None:
    """An empty range on the profiler's host timeline: a point in time."""
    with torch.profiler.record_function(name):
        pass


class _NoSpan:
    """The shared context :func:`span` returns while the tracer is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


class Span:
    """One span: open inside its ``with`` block, a record after it."""

    __slots__ = ("tracer", "name", "id", "parent", "t0", "t1", "child_ns", "events",
                 "device_ms", "counts", "totals", "sites")

    def __init__(self, tracer: "Tracer", name: str):
        self.tracer = tracer
        self.name = name
        self.child_ns = 0
        self.events = None
        self.device_ms: Optional[float] = None
        self.counts: Dict[str, int] = {}  # this span's own
        self.totals: Dict[str, int] = {}  # its children's until it closes, then inclusive
        self.sites: Dict[str, int] = {}  # this span's syncs by file:line

    def __enter__(self):
        tr = self.tracer
        stack = tr._stack
        if not stack:
            tr._owner = threading.get_ident()
            tr._hook_syncs()
        self.parent = stack[-1].id if stack else 0
        self.id = tr._next_id
        tr._next_id += 1
        if _autograd_profiler._is_profiler_enabled:
            _mark(f"apt>{self.name}#{self.id}")
        self.events = tr._event_pair()
        if self.events is not None:
            self.events[0].record()
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        tr = self.tracer
        if self.events is not None:
            self.events[1].record()
        stack = tr._stack
        stack.pop()
        if _autograd_profiler._is_profiler_enabled:
            _mark(f"apt<{self.name}#{self.id}")
        totals = self.totals
        for k, n in self.counts.items():
            totals[k] = totals.get(k, 0) + n
        if stack:
            parent = stack[-1]
            parent.child_ns += self.t1 - self.t0
            for k, n in totals.items():
                parent.totals[k] = parent.totals.get(k, 0) + n
        tr._keep(self)
        if not stack:
            tr._unhook_syncs()
        return False

    @property
    def host_ns(self) -> int:
        return self.t1 - self.t0


class Tracer:
    """Spans and counters of one process (:data:`TRACER`)."""

    #: records kept; past it the oldest are dropped
    max_records = 20000

    def __init__(self):
        self.records: Deque[Span] = deque()
        self.dropped = 0
        self._stack: List[Span] = []
        self._owner = 0  # the thread the open spans belong to
        self._forced = 0
        self._next_id = 1
        self._free_events: List[Any] = []
        self._sync_hook = None

    # -- on and off --------------------------------------------------------
    def span(self, name: str):
        """A context that records a span named ``name`` while the tracer is
        on, and the shared no-op context while it is off."""
        if self._forced or _autograd_profiler._is_profiler_enabled:
            if not self._stack or self._owner == threading.get_ident():
                return Span(self, name)
        return NO_SPAN

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to counter ``name`` of the innermost open span (nothing
        while no span is open)."""
        if self._stack and self._owner == threading.get_ident():
            counts = self._stack[-1].counts
            counts[name] = counts.get(name, 0) + n

    @contextlib.contextmanager
    def tracing(self):
        """The tracer on for the block, profiler or not."""
        self._forced += 1
        try:
            yield self
        finally:
            self._forced -= 1

    def reset(self) -> None:
        """Drop every record and the count of dropped ones."""
        for r in self.records:
            self._release(r)
        self.records.clear()
        self.dropped = 0

    # -- device events -------------------------------------------------------
    def _event_pair(self):
        if not torch.cuda.is_initialized():
            return None
        free = self._free_events
        if len(free) >= 2:
            return free.pop(), free.pop()
        return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def _release(self, r: Span) -> None:
        if r.events is not None:
            self._free_events.extend(r.events)
            r.events = None

    def _keep(self, r: Span) -> None:
        if len(self.records) >= self.max_records:
            self._release(self.records.popleft())
            self.dropped += 1
        self.records.append(r)

    # -- blocking syncs -------------------------------------------------------
    def _hook_syncs(self) -> None:
        """While a span is open: every blocking CUDA call warns, and the
        warning is counted (on the spans' thread) instead of shown."""
        hook = warnings.catch_warnings()
        hook.__enter__()
        warnings.filterwarnings("always", message=SYNC_WARNING)
        shown = warnings.showwarning
        stack = self._stack

        def showwarning(message, category, filename, lineno, file=None, line=None):
            if not str(message).startswith(SYNC_WARNING):
                shown(message, category, filename, lineno, file, line)
            elif stack and self._owner == threading.get_ident():
                top = stack[-1]
                top.counts["syncs"] = top.counts.get("syncs", 0) + 1
                site = _port_site(filename, lineno)
                top.sites[site] = top.sites.get(site, 0) + 1

        warnings.showwarning = showwarning
        mode = None
        if torch.cuda.is_initialized():
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
        self._sync_hook = (hook, mode)

    def _unhook_syncs(self) -> None:
        hook, mode = self._sync_hook
        self._sync_hook = None
        if mode is not None:
            torch.cuda.set_sync_debug_mode(mode)
        hook.__exit__(None, None, None)

    # -- the span table ------------------------------------------------------
    def report(self, records: Optional[Iterable[Span]] = None) -> Dict[str, Any]:
        """The span table of ``records`` (every kept record by default).

        Per span name: ``calls``; ``host_ms`` and ``self_ms`` (less the
        children's host time); ``device_ms`` (between the span's CUDA
        events, None without them); ``syncs`` and ``launches`` inside the
        span, its children included, and ``self_syncs`` / ``self_launches``
        put down to it as the innermost span; ``counts`` (every counter,
        children included); ``sync_sites`` (its own syncs by ``file:line``,
        most first).  Each numeric figure again under ``per_batch``, over
        the ``mesh.step`` spans among the records.  Synchronises the device
        once when it resolves CUDA events.
        """
        recs = list(self.records) if records is None else list(records)
        self._resolve(recs)
        spans: Dict[str, Dict[str, Any]] = {}
        sites_all: Dict[str, int] = {}
        for r in sorted(recs, key=lambda r: r.id):
            row = spans.setdefault(r.name, {
                "calls": 0, "host_ms": 0.0, "self_ms": 0.0, "device_ms": None,
                "syncs": 0, "self_syncs": 0, "launches": 0, "self_launches": 0,
                "counts": {}, "sync_sites": {}})
            row["calls"] += 1
            row["host_ms"] += r.host_ns * 1e-6
            row["self_ms"] += (r.host_ns - r.child_ns) * 1e-6
            if r.device_ms is not None:
                row["device_ms"] = (row["device_ms"] or 0.0) + r.device_ms
            row["syncs"] += r.totals.get("syncs", 0)
            row["self_syncs"] += r.counts.get("syncs", 0)
            row["launches"] += r.totals.get("launches", 0)
            row["self_launches"] += r.counts.get("launches", 0)
            for k, n in r.totals.items():
                row["counts"][k] = row["counts"].get(k, 0) + n
            for site, n in r.sites.items():
                row["sync_sites"][site] = row["sync_sites"].get(site, 0) + n
                key = f"{site} in {r.name}"
                sites_all[key] = sites_all.get(key, 0) + n
        batches = spans.get(BATCH_SPAN, {}).get("calls", 0)
        for row in spans.values():
            row["sync_sites"] = _most_first(row["sync_sites"])
            row["per_batch"] = None if not batches else {
                k: (None if row[k] is None else row[k] / batches)
                for k in ("calls", "host_ms", "self_ms", "device_ms", "syncs", "self_syncs",
                          "launches", "self_launches")}
        return {"batches": batches, "records": len(recs), "dropped": self.dropped,
                "spans": spans, "sync_sites": _most_first(sites_all)}

    def _resolve(self, recs: List[Span]) -> None:
        pending = [r for r in recs if r.events is not None]
        if not pending:
            return
        torch.cuda.synchronize()
        for r in pending:
            r.device_ms = r.events[0].elapsed_time(r.events[1])
            self._release(r)


def _most_first(counts: Dict[str, int]) -> List[List[Any]]:
    return [[k, n] for k, n in sorted(counts.items(), key=lambda kv: -kv[1])]


def _port_site(filename: str, lineno: int) -> str:
    """``file:line`` of the innermost frame of the port on the stack, with
    the port's line that called it in front where there is one
    (``models/roe.py:208 > ops/_device.py:56``), else the warning's own
    place."""
    f = sys._getframe(2)
    sites: List[str] = []
    while f is not None and len(sites) < 2:
        path = f.f_code.co_filename
        if path.startswith(PACKAGE_DIR) and path != __file__:
            sites.append(f"{path[len(PACKAGE_DIR):]}:{f.f_lineno}")
        elif sites:
            break
        f = f.f_back
    return " > ".join(reversed(sites)) if sites else f"{os.path.basename(filename)}:{lineno}"


#: the process's tracer
TRACER = Tracer()
span = TRACER.span
count = TRACER.count
tracing = TRACER.tracing
report = TRACER.report


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a ``torch.profiler`` trace (host activity, and the card's
    kernels when a card is present) with the tracer on, and write into
    ``log_dir`` when the block ends the Chrome trace (Perfetto-readable,
    ``trace_<pid>_<ns>.json``) and beside it the block's span table
    (:func:`report`, ``spans_<pid>_<ns>.json``).  Yields the profiler.

    Usage::

        with device_trace("traces"):
            pipe.step(xb)
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with tracing():
        first = TRACER._next_id
        with profile(activities=activities) as prof:
            yield prof
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        table = report(r for r in TRACER.records if r.id >= first)
    stamp = f"{os.getpid()}_{time.time_ns()}"
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{stamp}.json"))
    with open(os.path.join(log_dir, f"spans_{stamp}.json"), "w") as f:
        json.dump(table, f, indent=1)
