"""What decides ``correct``: the window's answers against the plain reference.

A sample of the backlog's clips drawn from the seed (the configuration's
``check_clips``) is run through the plain reference (``plainref``) on the
CPU once the window has closed.
Every answer the window produced for a sampled clip (each backlog batch
comes round many times) is compared with the reference's answer for it.
The configuration lists the numbers compared (``checks``): each takes one
per-clip output and is the largest absolute gap of any sampled clip over
all its answers (``max_abs``), the most values that differ in one
answer of a clip (``mismatches``), or how many sampled clips have any
value that differs in any answer (``clips_differing``), with its limit.
An answer without a row a clip fails the run.
"""

from __future__ import annotations

import os
import sys
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

SCALE = np.float32(1.0 / 32767.0)


def sample(seed: int, backlog_clips: int, k: int) -> np.ndarray:
    """``k`` distinct flat indices into the backlog, drawn from the seed."""
    g = torch.Generator().manual_seed((int(seed) * 2654435761 + 1) % 2**63)
    return np.sort(torch.randperm(backlog_clips, generator=g)[:k].numpy())


def decode(pcm: torch.Tensor) -> torch.Tensor:
    """int16 PCM to float32, as the window does on the card."""
    return pcm.to(torch.float32) * torch.tensor(SCALE)


def reference(config: Dict[str, Any], pcm: torch.Tensor, block: int = 32,
              store: Optional[Callable] = None) -> Dict[str, np.ndarray]:
    """The plain reference's per-clip outputs for int16 clips ``pcm`` (k, N),
    in blocks of ``block`` clips, on the CPU."""
    import plainref

    torch.set_num_threads(max(1, os.cpu_count() or 1))
    parts: List[Dict[str, np.ndarray]] = []
    for i in range(0, pcm.shape[0], block):
        parts.append(plainref.per_clip(config["model"], config["params"],
                                       decode(pcm[i : i + block]), store=store))
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def gaps(kind: str, got: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Clip by clip (the first axis): the largest absolute gap over the
    clip's values (``max_abs``; infinite where either side is NaN), how
    many of its values differ (``mismatches``), or 1 where any of its
    values differs, else 0 (``clips_differing``)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if kind == "max_abs":
        d = np.abs(got - ref)
        d = np.where(np.isnan(d), np.inf, d)
        return d.reshape(d.shape[0], -1).max(axis=1, initial=0.0)
    if kind == "mismatches":
        return (got != ref).reshape(got.shape[0], -1).sum(axis=1).astype(np.float64)
    if kind == "clips_differing":
        return (got != ref).reshape(got.shape[0], -1).any(axis=1).astype(np.float64)
    raise ValueError(f"unknown check kind {kind!r}")


def worst_by_clip(config: Dict[str, Any], answers, ref: Dict[str, np.ndarray], k: int
                  ) -> Dict[str, np.ndarray]:
    """Each check's worst reading over every answer of each of the ``k``
    sampled clips; ``answers`` are ``(outputs, at)`` pairs, the outputs'
    rows for the sampled clips at places ``at``."""
    out = {}
    for c in config["checks"]:
        key, kind = c["output"], c["kind"]
        worst = np.zeros(k)
        for ans, at in answers:
            worst[at] = np.maximum(worst[at], gaps(kind, ans[key], ref[key][at]))
        out[c["name"]] = worst
    return out


def number(kind: str, worst: np.ndarray) -> float:
    """A check's number: the clips that differ (``clips_differing``), or
    the largest reading of any clip (the others)."""
    if kind == "clips_differing":
        return float(worst.sum())
    return float(worst.max(initial=0.0))


def keep_rows(idx: np.ndarray, B: int) -> Dict[int, np.ndarray]:
    """The sampled rows of each backlog batch, in the sample's order."""
    return {int(b): idx[idx // B == b] % B for b in np.unique(idx // B)}


def judge(config: Dict[str, Any], idx: np.ndarray, backlog: torch.Tensor,
          window: Dict[str, Any]) -> Dict[str, Any]:
    """Compare the window's answers for the sampled clips ``idx`` (flat
    indices into the backlog) with the reference.  Returns ``correct``, the
    numbers with their limits, how many answers were compared and how many
    failed (an answer without a row a clip), the reference's outputs and
    each check's worst reading by clip."""
    nb, B = backlog.shape[0], backlog.shape[1]
    ref = reference(config, backlog.reshape(nb * B, -1)[torch.as_tensor(idx)])
    answers = []
    failed = compared = 0
    for ans, b in zip(window["answers"], window["which"]):
        if ans is None:
            failed += B
            continue
        at = np.flatnonzero(idx // B == b)
        if at.size:
            answers.append((ans, at))
            compared += at.size
    worst = worst_by_clip(config, answers, ref, idx.size)
    got = {c["name"]: {"value": number(c["kind"], worst[c["name"]]), "limit": c["limit"]}
           for c in config["checks"]}
    correct = failed == 0 and compared > 0 and all(
        v["limit"] is not None and v["value"] <= v["limit"] for v in got.values())
    return {"correct": correct, "numbers": got, "compared": compared, "failed": failed,
            "ref": ref, "worst": worst}


def report(numbers: Dict[str, Dict[str, float]], compared: int, file=sys.stderr) -> None:
    """The numbers compared, each beside its limit, as the last lines on
    standard error."""
    print(f"answers compared with the reference: {compared}", file=file)
    for name, v in numbers.items():
        verdict = "ok" if v["limit"] is not None and v["value"] <= v["limit"] else "OVER"
        print(f"check {name}: {v['value']!r} limit {v['limit']!r} {verdict}", file=file)
