"""Serving layer of the port. Two lanes:

* **Coloring service.** ``repro_torch.serve.coloring`` serves coloring
  over the spec/plan front door. The sync :class:`ColoringService` has an
  LRU plan cache keyed by the ``(spec, PlanShape)`` bucket envelope and
  same-key micro-batching; the production shape is
  :class:`AsyncColoringService`: bounded admission onto per-tenant queues,
  deficit-round-robin fairness, deadline-aware micro-batch flushing (size
  OR age), per-tenant edge-delta streams, and checkpoint/restore of the
  whole serving state in the reference's format. Observability rides
  :class:`repro_torch.serve.metrics.WindowedMetrics`. CLI:
  ``PYTHONPATH=src python -m repro_torch.serve --smoke --device cpu``
  (drop ``--device cpu`` to run on the card).

* **LM serving.** The family-dispatched cache/decode primitives live in
  ``repro_torch.models`` (``cache_spec``, ``init_cache``, ``decode_step``,
  ``forward(..., caches=)``), each architecture's cache layout next to its
  math; this package re-exports them as the serving API, and
  ``python -m repro_torch.launch.serve`` serves batches.

Every name resolves lazily, so importing the package (and
``python -m repro_torch.serve``) loads neither lane until it is used.
"""
_COLORING = ("ColoringService", "ServedReport", "PlanCache",
             "AsyncColoringService", "AsyncServed", "ServeHandle",
             "AdmissionError")
_METRICS = ("WindowedMetrics", "FLUSH_REASONS", "RESTART_INVARIANT")
_LM = ("cache_spec", "init_cache", "decode_step", "forward")

__all__ = [*_LM, *_COLORING, *_METRICS]


def __getattr__(name):
    # lazy (PEP 562): keeps `python -m repro_torch.serve.coloring` free of
    # the runpy double-import warning and the package import light
    if name in _COLORING:
        from . import coloring
        return getattr(coloring, name)
    if name in _METRICS:
        from . import metrics
        return getattr(metrics, name)
    if name in _LM:
        from .. import models
        return getattr(models, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
