"""Host layout per graph served, in ms: the program's ``plan.layout`` spans
(``ColoringPlan._canonicalize``: lowering, edge list, slot map and padding,
copies to the card) recorded over the traced window, summed, over the
requests served. None where the program records no spans."""


def read(ctx):
    from repro_torch.kernels import ops
    log = getattr(ops, "spans", None)
    if log is None or not ctx.window.requests:
        return None
    ns = [r.end_ns - r.start_ns for r in log()
          if r.name == "plan.layout" and r.end_ns is not None]
    return sum(ns) * 1e-6 / ctx.window.requests if ns else None
