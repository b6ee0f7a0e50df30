"""Device time of the radix sorts per graph served, in ms: every kernel in
the traced window whose name holds ``DeviceRadixSort``, over the requests
served. These are the kernels ``torch.sort`` launches for the ``sort``
engine's two stable sorts a sweep, full sweep and frontier slab alike:
CUB's one-sweep radix sort, ``DeviceRadixSortHistogramKernel``,
``DeviceRadixSortExclusiveSumKernel`` and ``DeviceRadixSortOnesweepKernel``
(read off an H100's trace, torch 2.11.0+cu128; a slab of a few million
pairs takes the same path, and torch's in-place sort of a short row never
runs here). None where the trace holds none."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.ops or not ctx.window.requests:
        return None
    us = [op.dur_us for op in ctx.trace.ops
          if op.cat == "kernel" and "DeviceRadixSort" in op.name]
    return sum(us) * 1e-3 / ctx.window.requests if us else None
