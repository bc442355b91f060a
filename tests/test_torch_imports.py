"""Import guard: every module of the port, ``chip_smoke.py``, the port's
tools (the stage profiler, the backfill scaling tool, the main-shape timer)
and its examples that run on the card import in a process where JAX, the JAX package and the
host libraries the card's machine lacks (pandas, pyarrow, matplotlib,
psutil, boto3, sqlalchemy, IPython, ipywidgets, requests) cannot be
imported.  A meta-path finder refuses them; one subprocess imports each
module (a script by its path) in turn and reports each one's outcome, one
case per module."""

import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

import audio_processing_tools_tpu_torch as pkg

REPO = Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "audio_processing_tools_tpu", "pandas", "pyarrow", "matplotlib",
           "psutil", "boto3", "sqlalchemy", "IPython", "ipywidgets", "requests")
MODULES = sorted([pkg.__name__] + [m.name for m in pkgutil.walk_packages(
    pkg.__path__, pkg.__name__ + ".")]) + ["chip_smoke"]
#: scripts outside the package, imported from their paths (their main()
#: runs only under ``__main__``)
SCRIPTS = ["tools/profile_torch_stages.py", "tools/bench_torch_backfill_scaling.py",
           "tools/time_main_shapes.py", "tools/time_mixed_tiles.py",
           "examples/torch_streaming_detect.py", "examples/torch_tune_thresholds.py"]

PROBE = """
import importlib, importlib.abc, importlib.util, json, sys, traceback
BLOCKED = set(%r)
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
out = {}
for name in %r:
    try:
        if name.endswith(".py"):
            spec = importlib.util.spec_from_file_location("_probe_" + name.replace("/", "_")[:-3], name)
            spec.loader.exec_module(importlib.util.module_from_spec(spec))
        else:
            importlib.import_module(name)
        out[name] = "ok"
    except BaseException:
        out[name] = traceback.format_exc(limit=3)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
print(json.dumps({"modules": out, "leaked": leaked}))
"""


@pytest.fixture(scope="module")
def outcomes():
    r = subprocess.run([sys.executable, "-c", PROBE % (BLOCKED, MODULES + SCRIPTS)], cwd=str(REPO),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["leaked"] == [], res["leaked"]
    return res["modules"]


def test_walk_finds_the_slice():
    new = {"parallel", "parallel.mesh", "parallel.sequence", "cli.backfill", "cli.corpus",
           "cli.header_parser", "cli.audio_parser", "framework.batch", "framework.parquet_io",
           "utils", "utils.corpus", "utils.profiling", "io.tabular", "postprocess",
           "postprocess.rain", "postprocess.noise", "evaluation", "viz", "viz.visualize_audio",
           "ops.sweep", "tuning", "tuning.profiles", "tuning.grid_search", "tuning.gradient",
           "tuning.call_native", "tuning.classification_algo", "tuning.dsp_integ",
           "tuning.device_backend", "tuning.visualization_utils", "viz.visualize_noise_output",
           "labeler"}
    assert {f"{pkg.__name__}.{m}" for m in new} <= set(MODULES)


def test_walk_finds_the_surface():
    """The dry-run entry, the edge shims and the CAF and ffmpeg ALAC routes
    are in the walk."""
    new = {"entry", "edge", "edge.band_noise_estimator", "edge.band_noise_processor",
           "edge.device_dsd_processing_emulator", "edge.dsp_rain_detection",
           "edge.feature_extraction", "edge.rain_frame_classifier",
           "edge.rain_signal_processor", "edge.time_domain_detector", "edge.parameter_tuning",
           "edge.parameter_tuning.call_c_fun", "edge.parameter_tuning.classification_algo",
           "edge.parameter_tuning.grid_search", "io.caf", "io.alac"}
    assert {f"{pkg.__name__}.{m}" for m in new} <= set(MODULES)


@pytest.mark.parametrize("module", MODULES)
def test_module_imports_without_jax_or_host_libraries(outcomes, module):
    assert outcomes[module] == "ok", outcomes[module]


@pytest.mark.parametrize("script", SCRIPTS)
def test_script_imports_without_jax_or_host_libraries(outcomes, script):
    assert outcomes[script] == "ok", outcomes[script]
