"""Device-to-host copies per graph served (each is a wait of the host on
the device: the round loop's syncs and the colors' return)."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.ops or not ctx.window.requests:
        return None
    n = sum(1 for op in ctx.trace.ops
            if op.cat == "gpu_memcpy" and "DtoH" in op.name)
    return n / ctx.window.requests
