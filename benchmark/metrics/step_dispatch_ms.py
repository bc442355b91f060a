"""Host dispatch ms a batch: the host's time inside the traced segment's
``mesh.step`` spans (between their marks on the profiler's clock), less its
time inside blocking CUDA calls (the trace's sync events inside them)."""

from harness.spans import segment


def read(ctx):
    seg = segment(ctx)
    return None if seg is None else seg.dispatch_ms
