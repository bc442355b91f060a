"""The card's peak of allocated memory over the window, in GiB
(``torch.cuda.max_memory_allocated`` after a reset at the window's start)."""


def read(ctx):
    if not ctx.peak_bytes:
        return None
    return ctx.peak_bytes / 2**30
