"""Launches of the port's own CUDA kernels a batch inside the step: the
tracer's ``launches`` counter (``_kernels.count``) in the traced segment's
``mesh.step`` spans, over those spans."""

from harness.spans import segment


def read(ctx):
    seg = segment(ctx)
    return None if seg is None else seg.per_batch("launches")
