"""Framework layer: the processor protocol and its adapters.

Counterpart of ``audio_processing_tools_tpu/framework/__init__.py``; the
batch orchestration (``batch.py``, ``parquet_io.py``) is not ported yet.
"""

from audio_processing_tools_tpu_torch.framework.processor import (
    AudioProcessor,
    BaseProcessor,
    NoiseProcessor,
    RainProcessor,
    has_processor,
)

__all__ = [
    "AudioProcessor",
    "BaseProcessor",
    "RainProcessor",
    "NoiseProcessor",
    "has_processor",
]
