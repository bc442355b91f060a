"""The readers of the port's spans and counters (``harness/spans.py`` and the
five metrics on it) on a hand-made trace: two batches whose spans, idle
gaps and sync events lie at known places, and the tracer's own records of
those spans with known counts."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from harness.spec import reader
from harness.trace import SPAN, Trace

from audio_processing_tools_tpu_torch.utils import profiling

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
#: one batch of 1,000 us: span -> (start, end), parent first
LAYOUT = {"mesh.step": (0, 900), "mesh.shard": (0, 50), "mesh.engine": (50, 700),
          "spectral.detect": (100, 600), "mesh.split": (700, 720),
          "mesh.aggregates": (720, 900)}
#: the card busy; idle 60-120 (mesh.engine), 500-560 (spectral.detect),
#: 740-800 (mesh.aggregates), 900-1000 (between batches)
KERNELS = [(0, 60), (120, 500), (560, 740), (800, 900)]
#: CUDA calls on the host: a copy in the engine that does not block, a sync
#: in the aggregates, one across the step's end (20 us inside), one in the
#: readback
SYNCS = [("cudaMemcpyAsync", 300, 330), ("cudaStreamSynchronize", 750, 790),
         ("cudaStreamSynchronize", 880, 920), ("cudaMemcpy", 950, 980)]


def _event(name, s, t, device=CPU):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=s, end=t),
                           device_type=device, thread=1)


def _spans(batches=2):
    """The tracer's records of ``batches`` steps; returns each batch's ids."""
    ids = []
    with profiling.tracing():
        for _ in range(batches):
            got = {}
            with profiling.span("mesh.step") as step:
                got["mesh.step"] = step.id
                for name in ("mesh.shard", "mesh.engine"):
                    with profiling.span(name) as s:
                        got[name] = s.id
                        if name == "mesh.engine":
                            with profiling.span("spectral.detect") as d:
                                got["spectral.detect"] = d.id
                                profiling.count("syncs", 2)
                                profiling.count("launches", 3)
                for name in ("mesh.split", "mesh.aggregates"):
                    with profiling.span(name) as s:
                        got[name] = s.id
                        if name == "mesh.aggregates":
                            profiling.count("syncs")
            ids.append(got)
    return ids


def _trace(ids, device=True):
    events = [_event(SPAN, 0, 1000 * len(ids))]
    for j, got in enumerate(ids):
        o = 1000 * j
        for name, (b, e) in LAYOUT.items():
            events.append(_event(f"apt>{name}#{got[name]}", o + b, o + b))
            events.append(_event(f"apt<{name}#{got[name]}", o + e, o + e))
        events += [_event(n, o + s, o + t) for n, s, t in SYNCS]
        if device:
            events += [_event("kernel", o + s, o + t, CUDA) for s, t in KERNELS]
    return Trace(SimpleNamespace(events=lambda: events), len(ids))


@pytest.fixture
def ctx():
    profiling.TRACER.reset()
    with profiling.tracing():
        with profiling.span("mesh.step"):  # a step outside the segment: left out
            profiling.count("syncs", 100)
    yield SimpleNamespace(trace=_trace(_spans()))
    profiling.TRACER.reset()


def _read(name, c):
    return reader(name).read(c)


def test_counters_a_batch(ctx):
    assert _read("step_syncs_per_batch", ctx) == 3.0
    assert _read("step_launches_per_batch", ctx) == 3.0


def test_dispatch_leaves_out_the_blocking_calls_inside_the_step(ctx):
    # 900 us inside the step, less 40 us (aggregates) and 20 us (across its end)
    assert _read("step_dispatch_ms", ctx) == pytest.approx(0.84)


def test_idle_gaps_go_to_the_innermost_span(ctx):
    mesh, engine = _read("idle_ms.mesh", ctx), _read("idle_ms.engine", ctx)
    assert mesh == pytest.approx(0.06) and engine == pytest.approx(0.12)
    idle_ms = (ctx.trace.window_s - ctx.trace.busy_s) * 1e3 / ctx.trace.batches
    assert idle_ms == pytest.approx(0.28) and mesh + engine <= idle_ms


def test_no_device_activity_leaves_out_the_idle_metrics_only():
    profiling.TRACER.reset()
    c = SimpleNamespace(trace=_trace(_spans(), device=False))
    try:
        assert _read("idle_ms.mesh", c) is None and _read("idle_ms.engine", c) is None
        assert _read("step_syncs_per_batch", c) == 3.0
    finally:
        profiling.TRACER.reset()


def test_without_the_tracer_every_reader_gives_none(ctx, monkeypatch):
    monkeypatch.delattr(profiling, "parse_mark")  # a port before the tracer
    for name in ("step_syncs_per_batch", "step_launches_per_batch", "step_dispatch_ms",
                 "idle_ms.mesh", "idle_ms.engine"):
        assert _read(name, SimpleNamespace(trace=_trace([]))) is None
        assert _read(name, SimpleNamespace(trace=None)) is None


def test_the_table_names_the_stages_and_sites(ctx, capsys):
    _read("step_syncs_per_batch", ctx)
    _read("idle_ms.engine", ctx)
    err = capsys.readouterr().err
    assert err.count("spans: 2 batches") == 1  # printed once a segment
    assert "spectral.detect" in err and "dispatch ms a batch 0.840" in err
