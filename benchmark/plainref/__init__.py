"""The benchmark's plain reference: the fleet backfill's per-clip outputs.

Frozen copies of the CPU paths of ``audio_processing_tools_tpu_torch``
(the port's plain versions of its kernels, which its tests hold the
kernels to), in plain PyTorch and NumPy, cut to what the step's per-clip
outputs read.  It imports nothing of the port, of JAX or of the JAX
package, and takes nothing the port has made: it designs its own filters
and builds its own tables from the configuration.

:func:`per_clip` gives, for a float32 ``(B, N)`` batch, the per-clip
outputs that ``parallel/mesh.py::ShardedRainPipeline.step`` returns for
the same configuration.  The reference of a configuration's ``model`` is
``models/<model>.py``, found by that name, so a new model is a new file.
``store`` is applied to each stage's output tensor (the identity by
default); the benchmark's control passes a round trip through bfloat16.
"""

from __future__ import annotations

import importlib
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch


def per_clip(model: str, params: Dict[str, Any], x: torch.Tensor,
             store: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
             ) -> Dict[str, np.ndarray]:
    """The step's per-clip outputs of ``model`` for the rows of ``x`` (B, N),
    as NumPy arrays, from ``models/<model>.py``."""
    if not (Path(__file__).parent / "models" / f"{model}.py").is_file():
        raise ValueError(f"no reference for model {model!r}: models/{model}.py")
    ref = importlib.import_module(f"{__name__}.models.{model}")
    out = ref.per_clip(params, x, store)
    return {k: v.detach().cpu().numpy() for k, v in out.items()}
