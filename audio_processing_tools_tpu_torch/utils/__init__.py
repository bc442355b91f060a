"""Cross-cutting utilities: profiling/tracing helpers (the corpus generator
is ``utils.corpus``)."""

from audio_processing_tools_tpu_torch.utils.profiling import (
    device_trace,
    Timer,
    timed,
)

__all__ = ["device_trace", "Timer", "timed"]
