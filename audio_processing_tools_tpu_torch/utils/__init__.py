"""Cross-cutting utilities: the tracer and the profiler's exporter
(``utils.profiling``; the corpus generator is ``utils.corpus``)."""

from audio_processing_tools_tpu_torch.utils.profiling import (
    TRACER,
    count,
    device_trace,
    report,
    span,
    tracing,
)

__all__ = ["TRACER", "count", "device_trace", "report", "span", "tracing"]
