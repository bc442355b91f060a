"""The card's idle share of the traced segment, in percent: one less the
union of its kernel and copy intervals over the segment's length."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0.0 or not ctx.trace.device_events:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
