"""Device time per graph served, in ms, of every device op that is neither
one of the port's three hand-written kernels nor a copy: the slab fills and
scatters, scans, gathers and indexing the engine runs in PyTorch."""
from portbench.roofline import kernel_of


def read(ctx):
    if ctx.trace is None or not ctx.window.requests:
        return None
    ops = [op for op in ctx.trace.ops
           if op.cat != "gpu_memcpy" and kernel_of(op.name) is None]
    if not ops:
        return None
    return sum(op.dur_us for op in ops) * 1e-3 / ctx.window.requests
