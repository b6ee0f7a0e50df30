"""Serving layer of the port: the coloring lane.

``repro_torch.serve.coloring`` serves coloring over the spec/plan front
door. The sync :class:`ColoringService` has an LRU plan cache keyed by the
``(spec, PlanShape)`` bucket envelope and same-key micro-batching; the
production shape is :class:`AsyncColoringService`: bounded admission onto
per-tenant queues, deficit-round-robin fairness, deadline-aware
micro-batch flushing (size OR age), per-tenant edge-delta streams, and
checkpoint/restore of the whole serving state in the reference's format.
Observability rides :class:`repro_torch.serve.metrics.WindowedMetrics`.
CLI: ``PYTHONPATH=src python -m repro_torch.serve --smoke --device cpu``
(drop ``--device cpu`` to run on the card).
"""
_COLORING = ("ColoringService", "ServedReport", "PlanCache",
             "AsyncColoringService", "AsyncServed", "ServeHandle",
             "AdmissionError")
_METRICS = ("WindowedMetrics", "FLUSH_REASONS", "RESTART_INVARIANT")

__all__ = [*_COLORING, *_METRICS]


def __getattr__(name):
    # lazy (PEP 562): keeps `python -m repro_torch.serve.coloring` free of
    # the runpy double-import warning and the package import light
    if name in _COLORING:
        from . import coloring
        return getattr(coloring, name)
    if name in _METRICS:
        from . import metrics
        return getattr(metrics, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
