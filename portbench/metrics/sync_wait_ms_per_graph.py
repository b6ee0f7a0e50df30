"""Time the host waits on device reads per graph served, in ms: the
program's ``sync.<site>`` spans (every ``.tolist()`` of the round loop and
the report's colors) recorded over the traced window, summed, over the
requests served. None where the program records no spans."""


def read(ctx):
    from repro_torch.kernels import ops
    log = getattr(ops, "spans", None)
    if log is None or not ctx.window.requests:
        return None
    ns = [r.end_ns - r.start_ns for r in log()
          if r.name.startswith("sync.") and r.end_ns is not None]
    return sum(ns) * 1e-6 / ctx.window.requests if ns else None
