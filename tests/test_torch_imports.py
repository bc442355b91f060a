"""Import guard: every module of the port, and ``chip_smoke.py``, imports in
a process where JAX, the JAX package and the host libraries the card's
machine lacks (pandas, pyarrow, matplotlib, psutil, boto3, sqlalchemy)
cannot be imported.  A meta-path finder refuses them; one subprocess
imports each module in turn and reports each one's outcome, one case per
module."""

import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

import audio_processing_tools_tpu_torch as pkg

REPO = Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "audio_processing_tools_tpu", "pandas", "pyarrow", "matplotlib",
           "psutil", "boto3", "sqlalchemy")
MODULES = sorted([pkg.__name__] + [m.name for m in pkgutil.walk_packages(
    pkg.__path__, pkg.__name__ + ".")]) + ["chip_smoke"]

PROBE = """
import importlib, importlib.abc, json, sys, traceback
BLOCKED = set(%r)
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
out = {}
for name in %r:
    try:
        importlib.import_module(name)
        out[name] = "ok"
    except BaseException:
        out[name] = traceback.format_exc(limit=3)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
print(json.dumps({"modules": out, "leaked": leaked}))
"""


@pytest.fixture(scope="module")
def outcomes():
    r = subprocess.run([sys.executable, "-c", PROBE % (BLOCKED, MODULES)], cwd=str(REPO),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["leaked"] == [], res["leaked"]
    return res["modules"]


def test_walk_finds_the_slice():
    new = {"parallel", "parallel.mesh", "parallel.sequence", "cli.backfill", "cli.corpus",
           "cli.header_parser", "cli.audio_parser", "framework.batch", "framework.parquet_io",
           "utils", "utils.corpus", "utils.profiling", "io.tabular", "postprocess",
           "postprocess.rain", "postprocess.noise", "evaluation", "viz", "viz.visualize_audio"}
    assert {f"{pkg.__name__}.{m}" for m in new} <= set(MODULES)


@pytest.mark.parametrize("module", MODULES)
def test_module_imports_without_jax_or_host_libraries(outcomes, module):
    assert outcomes[module] == "ok", outcomes[module]
