"""Blocking syncs a batch inside the step, counted by the port's tracer:
``torch.cuda.set_sync_debug_mode("warn")`` warnings inside the traced
segment's ``mesh.step`` spans (``utils/profiling.py``), over those spans.
The readback's copies, outside the step, are not among them."""

from harness.spans import segment


def read(ctx):
    seg = segment(ctx)
    return None if seg is None else seg.per_batch("syncs")
