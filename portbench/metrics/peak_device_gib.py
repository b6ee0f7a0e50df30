"""The allocator's peak on the card over the window, in GiB
(``torch.cuda.max_memory_allocated`` after a reset at the window's start)."""


def read(ctx):
    if ctx.window_peak_bytes is None:
        return None
    return ctx.window_peak_bytes / 2**30
