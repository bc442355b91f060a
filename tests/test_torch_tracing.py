"""The port's tracer (``utils/profiling.py``) on the CPU: off it records
nothing, spans nest with their parents and self time, counters and syncs go
to the innermost open span, the backfill step gives its span tree with the
same per-clip outputs on and off, and under ``torch.profiler`` each span
leaves exactly its two empty boundary marks."""

import inspect
import sys
import warnings

import numpy as np
import pytest
import torch

from audio_processing_tools_tpu_torch import _kernels
from audio_processing_tools_tpu_torch.config import DEFAULT_MODE_BANDS
from audio_processing_tools_tpu_torch.parallel import ShardedRainPipeline, local_rows, make_mesh
from audio_processing_tools_tpu_torch.utils import profiling
from audio_processing_tools_tpu_torch.utils.profiling import (
    NO_SPAN,
    SYNC_WARNING,
    TRACER,
    Tracer,
    parse_mark,
    span,
    tracing,
)

FS = 11162


@pytest.fixture(autouse=True)
def clean_tracer():
    TRACER.reset()
    yield
    TRACER.reset()


def _by_name(records):
    out = {}
    for r in records:
        out.setdefault(r.name, []).append(r)
    return out


def test_off_records_nothing_and_returns_the_shared_no_op():
    assert span("mesh.step") is NO_SPAN and span("other") is NO_SPAN
    with span("mesh.step") as s:
        profiling.count("launches")
        assert s is None
    assert not TRACER.records and not TRACER._stack
    assert TRACER.report()["spans"] == {}


def test_nested_spans_record_parents_and_self_time():
    with tracing():
        with span("outer") as outer:
            with span("inner") as inner:
                sum(range(1000))
            with span("inner"):
                pass
    recs = _by_name(TRACER.records)
    assert [r.name for r in TRACER.records] == ["inner", "inner", "outer"]  # kept as they close
    assert outer.parent == 0 and all(r.parent == outer.id for r in recs["inner"])
    assert inner.id == outer.id + 1
    assert outer.child_ns == sum(r.host_ns for r in recs["inner"])
    row = TRACER.report()["spans"]
    assert row["outer"]["calls"] == 1 and row["inner"]["calls"] == 2
    assert row["outer"]["self_ms"] == pytest.approx(
        row["outer"]["host_ms"] - row["inner"]["host_ms"], abs=1e-9)
    assert row["inner"]["self_ms"] == pytest.approx(row["inner"]["host_ms"])
    assert row["outer"]["device_ms"] is None  # no CUDA events on the CPU


def test_kernel_launches_go_to_the_innermost_span():
    before = dict(_kernels.LAUNCHES)
    try:
        with tracing():
            with span("mesh.step"):
                _kernels.count("local_maxima")
                with span("roe.harmonics"):
                    _kernels.count("local_maxima")
                    _kernels.count("spectrogram_power")
        _kernels.count("local_maxima")  # no span open: the process total only
        assert _kernels.LAUNCHES["local_maxima"] == before["local_maxima"] + 3
        assert _kernels.LAUNCHES["spectrogram_power"] == before["spectrogram_power"] + 1
    finally:
        _kernels.LAUNCHES.update(before)
    rep = TRACER.report()
    step, harm = rep["spans"]["mesh.step"], rep["spans"]["roe.harmonics"]
    assert (step["launches"], step["self_launches"]) == (3, 1)
    assert (harm["launches"], harm["self_launches"]) == (2, 2)
    assert harm["counts"] == {"launches": 2}
    assert rep["batches"] == 1 and step["per_batch"]["launches"] == 3


def test_a_sync_warning_goes_to_its_span_and_its_line():
    shown = warnings.showwarning
    with tracing():
        with span("mesh.step"):
            with span("mesh.aggregates"):
                line = inspect.currentframe().f_lineno + 1
                warnings.warn(SYNC_WARNING + " (Triggered internally at x.cpp:1.)")
                warnings.warn(SYNC_WARNING)
                with pytest.warns(UserWarning, match="another warning"):
                    warnings.warn("another warning")
            # a sync made by the port is put down to the port's file:line, and
            # to the port's line that called it
            helper = {}
            exec(compile("import warnings\ndef f32():\n    warnings.warn(%r)\n" % SYNC_WARNING,
                         profiling.PACKAGE_DIR + "fake_device.py", "exec"), helper)
            exec(compile("f32()\nf32()\n", profiling.PACKAGE_DIR + "fake_stage.py", "exec"),
                 helper)
            assert warnings.showwarning is not shown
    assert warnings.showwarning is shown  # restored once no span is open
    rep = TRACER.report()
    agg, step = rep["spans"]["mesh.aggregates"], rep["spans"]["mesh.step"]
    assert (agg["syncs"], agg["self_syncs"]) == (2, 2)
    assert agg["sync_sites"] == [[f"test_torch_tracing.py:{line}", 1],
                                 [f"test_torch_tracing.py:{line + 1}", 1]]
    assert (step["syncs"], step["self_syncs"]) == (4, 2)
    assert step["sync_sites"] == [["fake_stage.py:1 > fake_device.py:3", 1],
                                  ["fake_stage.py:2 > fake_device.py:3", 1]]
    assert len(rep["sync_sites"]) == 4
    assert ["fake_stage.py:2 > fake_device.py:3 in mesh.step", 1] in rep["sync_sites"]


def test_records_past_the_cap_drop_the_oldest():
    tr = Tracer()
    tr.max_records = 3
    with tr.tracing():
        for i in range(5):
            with tr.span(f"s{i}"):
                pass
    assert [r.name for r in tr.records] == ["s2", "s3", "s4"] and tr.dropped == 2
    assert tr.report()["dropped"] == 2


def _spectral_clips():
    rng = np.random.default_rng(7)
    k = np.arange(800)
    ping = sum(a * np.sin(2 * np.pi * f * k / FS) for f, a in
               ((520, 1), (900, 0.5), (1600, 0.35), (2450, 0.25)))
    clips = []
    for b in range(4):
        x = (0.005 if b < 2 else 0.02) * rng.standard_normal(FS)
        for t0 in rng.integers(FS // 4, FS - 2000, 6 if b < 2 else 0):
            x[t0:t0 + 800] += 0.5 * np.exp(-k / 60.0) * ping
        clips.append(x)
    return np.stack(clips).astype(np.float32)


def _roe_clips():
    rng = np.random.default_rng(8)
    n = 4 * FS
    k = np.arange(1000)
    ping = sum((1.0 / h) * np.sin(2 * np.pi * 520 * h * k / FS) for h in range(1, 6))
    clips = []
    for b in range(2):
        x = 0.003 * rng.standard_normal(n)
        for t0 in rng.integers(0, n - 1200, 30 if b == 0 else 0):
            x[t0:t0 + 1000] += 0.6 * np.exp(-k / 80.0) * ping
        clips.append(x)
    return np.stack(clips).astype(np.float32)


MESH = {"mesh.shard", "mesh.engine", "mesh.split", "mesh.aggregates"}
TREES = {
    "spectral": (_spectral_clips, {"spectral.td_prefilter", "spectral.spectrogram",
                                   "spectral.detector_input", "spectral.detect",
                                   "spectral.noise_psd", "spectral.noise_floor"}, set()),
    "roe": (_roe_clips, {"roe.rows", "roe.combine"},
            {"roe.bandpass", "roe.spectrogram", "roe.pulse", "roe.harmonic0",
             "roe.harmonics", "roe.decision"}),
}


@pytest.mark.parametrize("model", sorted(TREES))
def test_the_step_gives_its_span_tree_and_the_same_outputs(model):
    clips, engine_children, rows_children = TREES[model]
    params = {"sample_rate": FS, "detector": {"mode_bands": list(DEFAULT_MODE_BANDS)},
              "clip_rain_min_frames": 2}
    pipe = ShardedRainPipeline(params, make_mesh(1, device="cpu"), model=model)
    xb = clips()
    off = pipe.step(xb)
    assert not TRACER.records
    with tracing():
        on = pipe.step(xb)
    for k in off["per_clip"]:
        a, b = local_rows(off["per_clip"][k]), local_rows(on["per_clip"][k])
        assert a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True), k
    for k in off["aggregates"]:
        assert np.array_equal(off["aggregates"][k], on["aggregates"][k]), k

    recs = _by_name(TRACER.records)
    by_id = {r.id: r for r in TRACER.records}
    assert set(recs) == {"mesh.step"} | MESH | engine_children | rows_children
    (step,) = recs["mesh.step"]
    assert step.parent == 0
    for name in MESH:
        assert [by_id[r.parent].name for r in recs[name]] == ["mesh.step"]
    for name in engine_children:
        assert {by_id[r.parent].name for r in recs[name]} == {"mesh.engine"}, name
    for name in rows_children:
        assert {by_id[r.parent].name for r in recs[name]} == {"roe.rows"}, name
    rep = TRACER.report()
    assert rep["batches"] == 1
    assert rep["spans"]["mesh.step"]["syncs"] == 0 and rep["spans"]["mesh.step"]["launches"] == 0


def test_under_the_profiler_each_span_leaves_its_two_empty_marks():
    from torch.profiler import ProfilerActivity, profile

    assert span("x") is NO_SPAN
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("mesh.step") as step:
            assert step is not None  # on while the profiler runs, no tracing() block
            with span("mesh.engine"):
                torch.ones(64).cumsum(0)
            with span("mesh.engine"):
                pass
    assert span("x") is NO_SPAN
    ids = {r.id: r.name for r in TRACER.records}
    assert len(ids) == 3
    marks = {}
    for e in prof.events():
        got = parse_mark(e.name)
        if got is None:
            continue
        is_start, name, sid = got
        assert ids[sid] == name
        assert not e.cpu_children  # wraps no work
        marks.setdefault(sid, []).append((is_start, e.time_range.start))
    assert sorted(marks) == sorted(ids)
    for sid, got in marks.items():
        (s0, t0), (s1, t1) = sorted(got, key=lambda m: (m[1], not m[0]))
        assert s0 and not s1 and t0 <= t1, (ids[sid], got)
    assert parse_mark("bench.step") is None and parse_mark("aten::add") is None


def test_the_tracer_adds_nothing_to_the_module_state_when_off():
    mods = set(sys.modules)
    stack, n = list(TRACER._stack), TRACER._next_id
    for _ in range(100):
        with span("mesh.step"):
            profiling.count("syncs")
    assert TRACER._next_id == n and TRACER._stack == stack and not TRACER.records
    assert set(sys.modules) == mods


def test_spans_follow_the_thread_that_opened_the_outermost_one():
    import threading

    seen = []

    def other():
        seen.append(span("engine.other") is NO_SPAN)
        profiling.count("launches")
        warnings.warn(SYNC_WARNING)  # not counted, not shown

    with tracing():
        with span("mesh.step"):
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
        with span("mesh.step"):  # a new outermost span, on this thread again
            pass
    assert seen == [True]
    row = TRACER.report()["spans"]["mesh.step"]
    assert row["calls"] == 2 and row["syncs"] == 0 and row["launches"] == 0
