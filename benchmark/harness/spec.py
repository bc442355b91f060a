"""``BENCHMARK.json`` and the files it names, found by name."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List

HERE = Path(__file__).resolve().parent.parent  # the benchmark's folder
ROOT = HERE.parent  # the checkout


def load_benchmark(root: Path = ROOT) -> Dict[str, Any]:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(bench: Dict[str, Any], workload: str) -> Dict[str, Any]:
    """The cell named ``workload``, with its configuration's entry, the
    configuration's file, its traffic mix and the metrics it reports."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; cells: {sorted(cells)}")
    w = cells[workload]
    entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    return {
        "workload": w,
        "config": json.loads((ROOT / entry["file"]).read_text()),
        "mix": load_mix(w["traffic"]),
        "end_to_end": reported(bench["end_to_end"], workload),
        "per_layer": reported(bench["per_layer"], workload),
    }


def load_mix(name: str) -> Dict[str, Any]:
    return json.loads((HERE / "workloads" / f"{name}.json").read_text())


def reported(metrics: List[Dict[str, Any]], workload: str) -> List[Dict[str, Any]]:
    """The metrics a cell reports: those that list it, and those that list
    no cells."""
    return [m for m in metrics if workload in m.get("workloads", [workload])]


def reader(name: str) -> ModuleType:
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
