"""The timed path: the fleet backfill's sharded step on a one-card mesh.

Each batch is what ``cli/backfill.py`` does with a batch, with the file
loading replaced by the backlog: the next ``B`` clips of int16 PCM are
uploaded (``non_blocking`` from pinned memory) and scaled by 1/32767 on the
card, ``ShardedRainPipeline.step`` runs them, and the configuration's
per-clip outputs are read back with ``local_rows``.  The loop is closed:
one batch after another.  Spans named ``bench.upload``, ``bench.step`` and
``bench.readback`` mark the three parts for the profiler.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function


class Backfill:
    """The port's backfill step for one configuration on ``device``."""

    def __init__(self, config: Dict[str, Any], device: torch.device):
        from audio_processing_tools_tpu_torch.parallel import (
            ShardedRainPipeline,
            local_rows,
            make_mesh,
        )

        self.device = device
        self.keys = list(config["readback"])
        self._local_rows = local_rows
        mesh = make_mesh(1, device=device.type)
        self.pipe = ShardedRainPipeline(config["params"], mesh, model=config["model"])
        self.scale = torch.tensor(1.0 / 32767.0, dtype=torch.float32, device=device)

    def batch(self, pcm: torch.Tensor) -> Dict[str, np.ndarray]:
        """One batch of int16 PCM (B, N) on the host, to its answers."""
        with record_function("bench.upload"):
            x = pcm.to(self.device, non_blocking=True).to(torch.float32) * self.scale
        with record_function("bench.step"):
            out = self.pipe.step(x)
        with record_function("bench.readback"):
            return {k: self._local_rows(out["per_clip"][k]) for k in self.keys}


def run(bf: Backfill, backlog: torch.Tensor, seconds: float, keep: Dict[int, np.ndarray],
        first: int = 0) -> Dict[str, Any]:
    """Batches back to back from backlog batch ``first`` on, until the
    window has lasted ``seconds``; the last batch ends the window.  Returns
    each batch's seconds, its backlog batch, the answers for the rows
    ``keep[b]`` of backlog batch ``b`` (None where an answer has not a row
    a clip) and the window's length."""
    nb, B = backlog.shape[0], backlog.shape[1]
    times: List[float] = []
    which: List[int] = []
    answers: List[Optional[Dict[str, np.ndarray]]] = []
    i = first
    t0 = time.perf_counter()
    while True:
        tb = time.perf_counter()
        got = bf.batch(backlog[i % nb])
        te = time.perf_counter()
        times.append(te - tb)
        b = i % nb
        which.append(b)
        rows = keep.get(b, np.zeros(0, np.int64))
        answers.append(None if any(np.shape(v)[:1] != (B,) for v in got.values())
                       else {k: v[rows] for k, v in got.items()})
        i += 1
        if te - t0 >= seconds:
            break
    return {"times": times, "which": which, "answers": answers, "seconds": te - t0}


def p95_ms(times: List[float]) -> float:
    """The 95th percentile of batch seconds, in ms (linear between ranks)."""
    return float(np.percentile(np.asarray(times, np.float64), 95.0)) * 1e3
