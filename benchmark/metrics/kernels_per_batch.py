"""Device kernels a batch: kernel launches the traced segment put on the
card (copies and sets left out), over the batches traced."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels:
        return None
    return len(ctx.trace.kernels) / ctx.trace.batches
