"""PyTorch / CUDA port of ``audio_processing_tools_tpu`` for one NVIDIA H100.

The JAX package beside this one is the reference; every module here names
its counterpart by file and line.  This package imports ``torch``,
``numpy`` and ``scipy``, never ``jax`` or the JAX package.

Precision is pinned at import: TF32 keeps a 10-bit mantissa, which would
break the port's 1e-5 bounds (the JAX package runs its products at
``Precision.HIGHEST``, ``models/frame_classifier.py:93-97`` and
``ops/filters.py:579-630``), so float32 matrix products and convolutions
run in full float32 on the card.
"""

import torch

__version__ = "0.1.0"  # pyproject.toml; the ETLs stamp their rows with it

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
