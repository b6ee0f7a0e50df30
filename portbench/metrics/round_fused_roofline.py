"""``round_fused``'s share of its roofline, in %: the sum over its launches
in the window of the frozen model's least time (``portbench.roofline``,
from each launch's geometry), over the sum of its device time in the trace.
Nothing is read unless the trace holds exactly the launches recorded."""
from portbench.roofline import bound_s, kernel_of


def read(ctx):
    if ctx.trace is None:
        return None
    bound = [bound_s(k, rows, width)
             for k, rows, width, _ in ctx.launches if k == "round_fused"]
    timed = [op.dur_us * 1e-6 for op in ctx.trace.ops
             if op.cat == "kernel" and kernel_of(op.name) == "round_fused"]
    if not bound or len(bound) != len(timed):
        return None
    return 100.0 * sum(bound) / sum(timed)
