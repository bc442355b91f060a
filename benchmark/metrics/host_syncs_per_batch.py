"""Host synchronisations a batch: CUDA runtime calls in the traced segment
that block the host until the card catches up (stream, event and device
synchronisation, and blocking copies), over the batches traced."""


def read(ctx):
    if ctx.trace is None:
        return None
    return ctx.trace.syncs / ctx.trace.batches
