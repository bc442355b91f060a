"""Multi-device scaling: device mesh, sharded batch step, corpus aggregation.

Counterpart of ``audio_processing_tools_tpu/parallel/__init__.py``.  The
file axis is an explicit :class:`Mesh` of ``torch.device`` entries: per-entry
clip batches on each device, corpus aggregates reduced on the host (summed
over gloo across processes), and the time-sharded spectrogram in
``parallel.sequence``.
"""

from audio_processing_tools_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    shard_batch,
    local_rows,
    ShardedRainPipeline,
    ShardedRows,
)

__all__ = ["Mesh", "make_mesh", "shard_batch", "local_rows", "ShardedRainPipeline",
           "ShardedRows"]
