"""ITERATIVE rounds per graph served that swept the whole edge list: the
program's ``round.full`` spans (round 0 of a cold start, and every later
round whose pending set spilled its frontier slab) recorded over the traced
window, over the requests served. None where the program records neither
``round.full`` nor ``round.frontier``."""


def read(ctx):
    from repro_torch.kernels import ops
    log = getattr(ops, "spans", None)
    if log is None or not ctx.window.requests:
        return None
    names = [r.name for r in log()
             if r.name in ("round.full", "round.frontier")]
    if not names:
        return None
    return names.count("round.full") / ctx.window.requests
