"""Device time of host-to-device copies per graph served, in ms (the
device's view of the host layout each request pays)."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.ops or not ctx.window.requests:
        return None
    us = sum(op.dur_us for op in ctx.trace.ops
             if op.cat == "gpu_memcpy" and "HtoD" in op.name)
    return us * 1e-3 / ctx.window.requests
