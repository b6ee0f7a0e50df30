"""(vertex, color) pairs the ``sort`` engine sorted per graph served, in
millions: Σ ``n`` of the program's ``mex.sort`` spans (one per call of the
engine's mex, full sweep or frontier slab; ``n`` counts the sweep's pairs
and one synthetic pair per row) recorded over the traced window, over the
requests served. None where the program records no such span."""


def read(ctx):
    from repro_torch.kernels import ops
    log = getattr(ops, "spans", None)
    if log is None or not ctx.window.requests:
        return None
    n = [r.n for r in log() if r.name == "mex.sort" and r.n is not None]
    return sum(n) * 1e-6 / ctx.window.requests if n else None
