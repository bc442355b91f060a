"""The card's idle ms a batch under the engine: idle gaps of the traced
segment whose middle falls while the innermost open span is ``mesh.engine``
or an engine stage inside it (``spectral.*``, ``roe.*``)."""

from harness.spans import segment


def read(ctx):
    seg = segment(ctx)
    return None if seg is None else seg.idle_ms_per_batch(engine=True)
