"""``correct`` comes out true for the program and false for the control and
for each fault the cells can have, through the harness's own run on the CPU
at a small size (the look for a card skipped)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from conftest import run_small, small_cell

CELLS = ["spectral-fleet-b1024", "roe-fleet-b1024"]


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    r = run_small(workload)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["answers_compared"] >= 4
    assert list(r)[-1] == "checks"


def _half(orig):
    """Half of the batch left out: the first half computed, its answers
    copied into the rest."""
    def per_clip(self, x):
        h = x.shape[0] // 2
        out = orig(self, x[:h])
        return {k: torch.cat([v, v[: x.shape[0] - h]]) for k, v in out.items()}
    return per_clip


def _altered(orig):
    """An answer altered where it is produced: one clip's frame classes, or
    its drop count."""
    def per_clip(self, x):
        out = dict(orig(self, x))
        if "frame_class" in out:
            fc = out["frame_class"].clone()
            fc[1] = (fc[1] + 1) % 3
            out["frame_class"] = fc
        else:
            out["rain_drop_count_mod"] = out["rain_drop_count_mod"].clone()
            out["rain_drop_count_mod"][1] += 1
        return out
    return per_clip


def _stale(orig):
    """A step that hands back the previous batch's answers."""
    last = {}

    def per_clip(self, x):
        out = orig(self, x)
        prev = last.get("out", out)
        last["out"] = out
        return prev
    return per_clip


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", [_half, _altered, _stale], ids=["half", "altered", "stale"])
def test_fault_is_not_correct(workload, fault, monkeypatch):
    from audio_processing_tools_tpu_torch.parallel.mesh import ShardedRainPipeline

    monkeypatch.setattr(ShardedRainPipeline, "_per_clip", fault(ShardedRainPipeline._per_clip))
    r = run_small(workload, seconds=1.0)
    assert not r["correct"], r["checks"]


#: clips the control test samples: its readings grow with the sample, and
#: need more clips than a small cell holds to reach the limits set at the
#: cells' 1,024 and 256
CONTROL_CLIPS = {"spectral-fleet-b1024": 64, "roe-fleet-b1024": 32}


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_a_limit(workload):
    """The reference with each stage's output stored in bfloat16 (the
    control) reads over at least one limit."""
    from harness import check, traffic

    n = CONTROL_CLIPS[workload]
    c = small_cell(workload)
    c["mix"]["batch"] = n // c["mix"]["backlog_batches"]
    config = c["config"]
    pcm = traffic.make_backlog(c["mix"], config, 2**32 + 9, torch.device("cpu")).reshape(n, -1)
    ref = check.reference(config, pcm)
    ctl = check.reference(config, pcm, store=lambda t: t.to(torch.bfloat16).to(t.dtype)
                          if t.is_floating_point() else t)
    worst = check.worst_by_clip(config, [(ctl, np.arange(n))], ref, n)
    over = [k["name"] for k in config["checks"]
            if check.number(k["kind"], worst[k["name"]]) > k["limit"]]
    assert over


@pytest.mark.card
def test_tf32_control_fails_on_the_card(card):
    """The program with its float32 matrix products in TF32 (the spectral
    configuration's control) reads over the flipped-clip limit at the cell's
    size, on the card."""
    import json
    import tempfile
    from pathlib import Path

    import calibrate

    with tempfile.TemporaryDirectory() as d:
        out = Path(d) / "cal.jsonl"
        calibrate.main(["--workload", "spectral-fleet-b1024", "--seeds", "5",
                        "--control-seeds", "5", "--controls", "tf32", "--seconds", "2",
                        "--out", str(out)])
        rows = [json.loads(line) for line in out.read_text().splitlines()]
    program = next(r for r in rows if r["reading"] == "program")["numbers"]
    tf32 = next(r for r in rows if r["reading"] == "control-tf32")["numbers"]
    limits = {k["name"]: k["limit"] for k in small_cell("spectral-fleet-b1024")["config"]["checks"]}
    assert all(program[k] <= limits[k] for k in limits)
    assert any(tf32[k] > limits[k] for k in limits)
