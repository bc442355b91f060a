"""``BENCHMARK.json`` against the benchmark's contract, and every file a
cell names found by its name."""

from __future__ import annotations

import json
import re

import pytest

from conftest import HERE, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_sizes():
    assert set(BENCH) == KEYS
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"] and all(PATH.match(p) for p in BENCH["paths"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    # the full check of 24 cells fits its time
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_texts():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            for key in ("config", "traffic"):
                if key in entry:
                    assert NAME.match(entry[key])
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key]
                    assert "\t" not in entry[key]
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    for pool in (metrics, [c["name"] for c in BENCH["configs"]],
                 [w["name"] for w in BENCH["workloads"]]):
        assert len(pool) == len(set(pool))


def test_metric_entries():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        for w in m.get("workloads", cells):
            assert w in cells
            assert w in e2e[m["moves"]].get("workloads", cells)
        if m["name"].endswith("_roofline") or m["name"].startswith("roofline"):
            assert m["unit"] == "%"
    for w in cells:  # every cell reports setup_s, another end-to-end metric and a per-layer one
        assert sum(w in m.get("workloads", cells) for m in BENCH["end_to_end"]) >= 2
        assert any(w in m.get("workloads", cells) for m in BENCH["per_layer"])


def test_cells_find_their_files():
    from harness.spec import cell, reader

    configs = {c["name"]: c for c in BENCH["configs"]}
    assert len({c["file"] for c in BENCH["configs"]}) == len(configs)
    pairs = set()
    for w in BENCH["workloads"]:
        assert w["chips"] == 1
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        c = cell(BENCH, w["name"])
        assert c["config"]["name"] == w["config"]
        assert (HERE / "workloads" / f"{w['traffic']}.json").is_file()
        for m in c["per_layer"]:
            assert callable(reader(m["name"]).read)
    for c in configs.values():
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert c["reduced"] == json.loads((ROOT / c["file"]).read_text())["reduced"]
    assert set(configs) == {w["config"] for w in BENCH["workloads"]}


@pytest.mark.parametrize("config", [c["file"] for c in BENCH["configs"]])
def test_every_check_has_its_limit(config):
    checks = json.loads((ROOT / config).read_text())["checks"]
    assert checks and all(isinstance(c["limit"], (int, float)) for c in checks)
