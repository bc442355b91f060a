"""The card's idle ms a batch under the mesh step's own spans: idle gaps of
the traced segment whose middle falls while the innermost open span is
``mesh.step``, ``mesh.shard``, ``mesh.split`` or ``mesh.aggregates``."""

from harness.spans import segment


def read(ctx):
    seg = segment(ctx)
    return None if seg is None else seg.idle_ms_per_batch(engine=False)
