"""Framework layer: processor protocol + batch orchestration.

Counterpart of ``audio_processing_tools_tpu/framework/__init__.py``, with
the same exports.  Processors that implement ``run_batch`` get whole
``(B, N)`` batches in one device call instead of per-file calls.
"""

from audio_processing_tools_tpu_torch.framework.processor import (
    AudioProcessor,
    BaseProcessor,
    RainProcessor,
    NoiseProcessor,
    has_processor,
)
from audio_processing_tools_tpu_torch.framework.batch import (
    process_audio_batches_v2,
    process_audio_batches,
    restore_state_df_from_parquet,
)

__all__ = [
    "AudioProcessor",
    "BaseProcessor",
    "RainProcessor",
    "NoiseProcessor",
    "has_processor",
    "process_audio_batches_v2",
    "process_audio_batches",
    "restore_state_df_from_parquet",
]
