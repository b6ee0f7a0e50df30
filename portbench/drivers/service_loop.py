"""Clients in a closed loop against the asynchronous coloring service.

Set-up starts an ``AsyncColoringService`` with the traffic's settings and its
worker thread, and warms it with one full flush (``max_batch`` graphs of one
tenant). In the window each client thread submits one graph of its share of
the pool, waits for the report on its handle, and submits the next, for
``seconds``. The window starts with the clients and closes at the last
report that reached its client within ``seconds``: a flush hands back its
graphs together, so a window cut at a fixed instant would count a whole
flush or none of it, by chance. ``served_graphs_per_s`` is the reports
delivered in the window over its length. Requests in flight at the close
are waited for and judged, and count toward nothing else.
"""
from __future__ import annotations

import threading
import time

from portbench.harness import Answered, Window


def setup(cell):
    from repro_torch.core import ColoringSpec
    from repro_torch.serve.coloring import AsyncColoringService
    t = cell.traffic
    svc = AsyncColoringService(default_spec=ColoringSpec(**cell.config["spec"]),
                               device=cell.device, **t["service"])
    with cell.worker_threads_report():
        svc.start()
    graphs = cell.program_graphs
    warm = [svc.submit(graphs[i % len(graphs)], tenant="warm")
            for i in range(t["service"]["max_batch"])]
    for h in warm:
        h.result(timeout=t["result_timeout_s"])
    cell.sync()
    return svc


def window(cell, svc, seconds: float) -> Window:
    t = cell.traffic
    graphs = cell.program_graphs
    clients, per_tenant = int(t["clients"]), int(t["clients_per_tenant"])
    records = [[] for _ in range(clients)]
    before = svc.metrics.snapshot()["cumulative"]
    t0 = time.perf_counter()
    close_t = t0 + seconds

    def client(k: int) -> None:
        share = list(range(k, len(graphs), clients)) or [k % len(graphs)]
        j = 0
        while time.perf_counter() < close_t:
            i = share[j % len(share)]
            j += 1
            ts = time.perf_counter()
            try:
                out = svc.submit(graphs[i], tenant=f"tenant{k // per_tenant}"
                                 ).result(timeout=t["result_timeout_s"])
            except Exception as e:  # judged: a request with no answer
                records[k].append((Answered(i, None, None, None, repr(e)),
                                   None))
                return
            te = time.perf_counter()
            rep = out.report
            records[k].append((Answered(i, rep.colors,
                                        rep.conflicts_per_round, te - ts),
                               te))

    threads = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(clients)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(seconds + 2 * t["result_timeout_s"])
    hung = sum(th.is_alive() for th in threads)
    after = svc.metrics.snapshot()["cumulative"]
    answers = [a for rec in records for a, _ in rec]
    answers += [Answered(-1, None, None, None, "client never returned")] * hung
    delivered = [te for rec in records for _, te in rec
                 if te is not None and te <= close_t]
    span = (max(delivered) - t0) if delivered else seconds
    flushes = after["flushes"] - before["flushes"]
    return Window(
        seconds=span, graphs=len(delivered), answers=answers,
        values={"served_graphs_per_s": len(delivered) / span},
        facts={"flushes": flushes,
               "requests": after["requests"] - before["requests"],
               "flush_exec_s": after["exec_s"] - before["exec_s"]})


def close(cell, svc) -> None:
    svc.stop()
