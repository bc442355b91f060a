"""The port's stage profiler and backfill scaling tool on the CPU at a
small size: ``tools/profile_torch_stages.py`` gives every stage name of
``tools/profile_stages.py`` (read from the JAX file) a finite eager time and
no graph time, with the reason; ``tools/bench_torch_backfill_scaling.py``
gives equal aggregates at 1 and 2 gloo processes.  Exact: names, counts and
aggregates."""

import importlib.util
import json
import math
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FS_1S = 11162  # samples of a 1 s clip
JAX_TOOL = REPO / "tools" / "profile_stages.py"


def _tool(name: str):
    spec = importlib.util.spec_from_file_location(f"_tool_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_stage_names():
    """The stage names of each ``stages = {...}`` dict of the JAX profiler,
    in the file's order: spectral, RoE, band noise."""
    src = JAX_TOOL.read_text()
    blocks = re.findall(r"stages = \{(.*?)\}", src, flags=re.S)
    names = [re.findall(r'"([^"]+)":', b) for b in blocks]
    return dict(zip(("spectral", "roe", "band_noise"), names))


def test_jax_stage_names_are_read():
    names = _jax_stage_names()
    assert names["spectral"][0] == names["roe"][0] == names["band_noise"][0] == "full"
    assert [len(v) for v in names.values()] == [7, 7, 5]


@pytest.mark.parametrize("model", ["spectral", "roe", "band_noise"])
def test_stage_profiler_on_the_cpu(model, monkeypatch, capsys):
    tool = _tool("profile_torch_stages")
    monkeypatch.setattr(sys, "argv", ["profile_torch_stages.py", "--device", "cpu", "--batch",
                                      "2", "--clip-sec", "1", "--iters", "2", "--trials", "1",
                                      "--model", model])
    assert tool.main() == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(rec["stages"]) == _jax_stage_names()[model]
    assert rec["model"] == model and rec["device"] == "cpu" and rec["iters"] == 2
    assert rec["batch"] == 2 and rec["clip_sec"] == (3.0 if model == "roe" else 1.0)
    for name, st in [*rec["stages"].items(), ("floor", rec["floor"])]:
        assert math.isfinite(st["eager_ms"]) and st["eager_ms"] > 0, name
        assert st["graph_ms"] is None and "CUDA graphs need a CUDA device" in st["graph_reason"]
        assert st["first_call_s"] >= 0, name
    if model == "spectral":
        assert rec["T_frames"] == 1 + FS_1S // 128 and rec["band_bins"] > 0
    if model == "band_noise":
        assert rec["T_frames"] == FS_1S // 512 and rec["audio_sec_per_sec"] is None
        assert rec["audio_sec_per_sec_eager"] > 0


def test_stage_scalars_are_the_same_on_repeated_calls():
    """A stage body is a function of its input: two calls give the same
    scalar (the chained steps rely on it), on every model."""
    tool = _tool("profile_torch_stages")
    for model in ("spectral", "roe", "band_noise"):
        prof = tool.build_profile(model, batch=2, clip_sec=1.0, device="cpu")
        for name, fn in prof.stages.items():
            a, b = float(fn(prof.x)), float(fn(prof.x))
            assert a == b and math.isfinite(a), (model, name)


def test_backfill_scaling_on_the_cpu():
    r = subprocess.run([sys.executable, str(REPO / "tools" / "bench_torch_backfill_scaling.py"),
                        "--nprocs", "1", "2", "--clips", "4", "--sec", "1", "--device", "cpu"],
                       cwd=str(REPO), capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    assert [row["nproc"] for row in rec["rows"]] == [1, 2]
    assert rec["aggregates"]["total_clips"] == 4 and rec["device"] == "cpu"
    assert rec["aggregates"]["total_rain_clips"] == 2  # the two heavy-rain clips
    for row in rec["rows"]:
        assert row["files_per_sec"] > 0 and row["efficiency_vs_n1"] > 0
