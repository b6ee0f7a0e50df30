"""Mean queue wait of a served request, in ms: the program's ``serve.queue``
spans, each from ``submit`` to the start of the request's flush, recorded
over the traced window. None where the program records no spans."""


def read(ctx):
    from repro_torch.kernels import ops
    log = getattr(ops, "spans", None)
    if log is None:
        return None
    ns = [r.end_ns - r.start_ns for r in log() if r.name == "serve.queue"]
    return sum(ns) * 1e-6 / len(ns) if ns else None
