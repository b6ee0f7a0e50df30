"""repro_torch's serving slice against the reference: ``WindowedMetrics``,
the sync ``ColoringService`` and the ``AsyncColoringService`` scheduler
(admission, deficit round-robin, size/deadline/drain flushes, streams)
under the same fake clock give the same flush reasons, queue ages,
admission order, ``AdmissionError`` and metrics snapshot as the
reference's, with colors equal; checkpoints cross between the packages
both ways and the next delta batch colors identically; the worker thread
serves; and ``python -m repro_torch.serve --smoke --device cpu`` exits 0.
The port runs on the CPU (``device="cpu"``)."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import FakeClock
import repro.core as R
import repro_torch.core as T
from repro.serve import coloring as RS
from repro.serve.metrics import WindowedMetrics as RWindowedMetrics
from repro.train import checkpoint as rckpt
from repro_torch.serve import coloring as TS
from repro_torch.serve.metrics import (FLUSH_REASONS, RESTART_INVARIANT,
                                       WindowedMetrics)
from repro_torch.train import checkpoint as tckpt

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "src")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


PKGS = {"reference": (R, RS), "torch": (T, TS)}


def _svc(pkg, clock, **kw):
    core, serve = PKGS[pkg]
    kw.setdefault("default_spec", core.ColoringSpec(
        strategy="iterative", engine="bitmap", concurrency=16))
    if pkg == "torch":
        kw["device"] = "cpu"
    return serve.AsyncColoringService(clock=clock, **kw)


def _graphs(core, family, scale, seeds):
    return [core.rmat.paper_graph(family, scale, seed=s) for s in seeds]


def _deltas(graph, k, m, seed=1):
    rng = np.random.default_rng(seed)
    V = graph.num_vertices
    base = graph.undirected_edges()
    return [(np.stack([rng.integers(0, V, m), rng.integers(0, V, m)], 1),
             base[rng.integers(0, base.shape[0], m)]) for _ in range(k)]


def _served(h):
    """A handle's result as comparable plain data."""
    r = h.result()
    out = (r.kind, r.tenant, r.cache_hit, r.batched, r.flush_reason,
           round(r.queue_age_s, 9), round(r.latency_s, 9))
    rep = r.result
    if r.kind == "delta":
        return out + (rep.inserted, rep.deleted, rep.seed_size,
                      rep.repaired)
    return out + (tuple(np.asarray(rep.colors)), rep.rounds,
                  tuple(rep.conflicts_per_round))


def _scenario(pkg):
    """One scripted run of the async scheduler on a fake clock: a flooding
    tenant, a second tenant, two envelope keys, a stream, an admission
    rejection, size/deadline/drain flushes. Returns every observable."""
    core, serve = PKGS[pkg]
    clock = FakeClock()
    svc = _svc(pkg, clock, max_queue_depth=7, tenant_quantum=1,
               max_batch=2, max_delay_s=1.0)
    small = _graphs(core, "RMAT-G", 6, range(5))
    big = _graphs(core, "RMAT-G", 7, range(2))
    stream_g = core.rmat.paper_graph("RMAT-ER", 6, seed=9)
    svc.open_stream("S", stream_g, core.ColoringSpec(
        strategy="recolor", engine="bitmap", concurrency=16))
    log, handles = [], []
    handles += [svc.submit(g, tenant="A") for g in small[:4]]
    handles += [svc.submit(big[0], tenant="B")]
    ins, dels = _deltas(stream_g, 2, 12)[0]
    handles += [svc.submit_delta("S", inserts=ins, deletes=dels)]
    handles += [svc.submit(small[4], tenant="B")]
    with pytest.raises(serve.AdmissionError):
        svc.submit(big[1], tenant="C")
    log.append(("backlog", svc.backlog))
    for dt in (0.0, 0.4, 0.7, 0.0, 1.5):
        clock.tick(dt)
        log.append(("pump", svc.pump(), [h.done for h in handles]))
    ins, dels = _deltas(stream_g, 2, 12)[1]
    handles += [svc.submit(big[1], tenant="C"),
                svc.submit_delta("S", inserts=ins, deletes=dels)]
    clock.tick(0.25)
    log.append(("drain", svc.drain(), svc.backlog))
    log.append(("served", dict(svc.tenant_served)))
    snap = svc.metrics.snapshot()
    snap["cumulative"].pop("retraces")   # program builds: process-local
    return log, [_served(h) for h in handles], snap, \
        np.asarray(svc.stream("S").colors)


def test_async_scheduler_matches_reference():
    want, got = _scenario("reference"), _scenario("torch")
    assert got[0] == want[0]
    for i, (a, b) in enumerate(zip(got[1], want[1])):
        assert a == b, f"request {i}"
    assert got[2] == want[2]
    np.testing.assert_array_equal(got[3], want[3])
    # the script did reach every flush reason and the rejection
    assert all(want[2]["cumulative"]["flush_reasons"][r] > 0
               for r in FLUSH_REASONS)
    assert want[2]["cumulative"]["rejected"] == 1


def test_sync_service_matches_reference():
    stats = {}
    for pkg, (core, serve) in PKGS.items():
        kw = {"device": "cpu"} if pkg == "torch" else {}
        svc = serve.ColoringService(cache_size=2, clock=FakeClock(), **kw)
        spec = core.ColoringSpec(engine="bitmap", concurrency=8)
        gs = _graphs(core, "RMAT-B", 6, range(3))
        one = svc.color(gs[0], spec)
        batch = svc.color_batch([(g, spec) for g in gs]
                                + [gs[1]])   # a bare graph: default spec
        stats[pkg] = ([np.asarray(one.report.colors)]
                      + [np.asarray(s.report.colors) for s in batch],
                      [(s.cache_hit, s.batched) for s in batch],
                      {k: v for k, v in svc.stats().items()
                       if k not in ("latency", "throughput_gps")})
    (c1, f1, s1), (c2, f2, s2) = stats["torch"], stats["reference"]
    for a, b in zip(c1, c2):
        np.testing.assert_array_equal(a, b)
    assert f1 == f2 and s1 == s2


def test_windowed_metrics_match_reference():
    clocks, ms = (FakeClock(), FakeClock()), []
    for clk, cls in zip(clocks, (WindowedMetrics, RWindowedMetrics)):
        m = cls(window_s=10.0, clock=clk)
        m.record_flush("size", latencies=[0.001] * 3, queue_ages=[0.0] * 3,
                       exec_s=0.003, cache_hit=False, retraces=1,
                       batched=True)
        clk.tick(5.0)
        m.record_flush("deadline", latencies=[0.009], queue_ages=[0.004],
                       exec_s=0.001, cache_hit=True, stream=True)
        m.record_rejected(2)
        clk.tick(6.0)
        ms.append(m)
    assert ms[0].snapshot() == ms[1].snapshot()
    state = ms[0].state_dict()
    assert state.keys() == ms[1].state_dict().keys()
    back = RWindowedMetrics(clock=FakeClock())
    back.load_state(state)
    # every cumulative counter but the longest flush, which the reference
    # does not checkpoint either
    got, want = (back.snapshot()["cumulative"],
                 ms[0].snapshot()["cumulative"])
    assert got.pop("max_exec_s") == 0.0 and want.pop("max_exec_s") > 0
    assert got == want
    with pytest.raises(ValueError, match="unknown flush reason"):
        ms[0].record_flush("tired", latencies=[], queue_ages=[], exec_s=0)
    assert RESTART_INVARIANT[0] == "requests"


# ----------------------------------------------------------- checkpoints
def test_checkpoint_files_cross_packages(tmp_path):
    tree = {"a": {"x": np.arange(6, dtype=np.int32).reshape(2, 3),
                  "y": np.float64(2.5)},
            "b": [np.int64(7), np.array([True, False])]}
    for k, (save, load) in enumerate([(tckpt.save, rckpt.load),
                                      (rckpt.save, tckpt.load)]):
        root = str(tmp_path / f"c{k}")
        for step in range(4):
            save(root, step, {**tree, "step": np.int64(step)}, keep=2,
                 meta={"schema": 1, "k": k})
        assert tckpt.all_steps(root) == [2, 3] == rckpt.all_steps(root)
        got, manifest, step = load(root)
        assert step == 3 and manifest["meta"] == {"schema": 1, "k": k}
        np.testing.assert_array_equal(got["a"]["x"], tree["a"]["x"])
        assert got["b"]["0"] == 7 and int(got["step"]) == 3
    # the two writers produce the same manifest for the same tree
    m = []
    for save, root in ((tckpt.save, tmp_path / "m0"),
                       (rckpt.save, tmp_path / "m1")):
        save(str(root), 5, tree)
        m.append(tckpt.load(str(root))[1])
    assert m[0] == m[1]
    # a corrupted array fails the checksum
    path = tckpt.step_dir(str(tmp_path / "m0"), 5)
    data = dict(np.load(os.path.join(path, "arrays.npz")))
    data["a__x"] = data["a__x"] + 1
    np.savez(os.path.join(path, "arrays.npz"), **data)
    with pytest.raises(IOError, match="checksum"):
        tckpt.load(str(tmp_path / "m0"))
    with pytest.raises(ValueError, match="__"):
        tckpt.save(str(tmp_path / "bad"), 0, {"a__b": np.zeros(1)})


def _stream_service(pkg, tmp):
    """A service with two tenant streams (sort and bitmap), two delta
    batches each, drained, checkpointed to ``tmp``. Returns (service,
    next deltas per tenant)."""
    core, serve = PKGS[pkg]
    svc = _svc(pkg, FakeClock(), max_batch=4, max_delay_s=0.0)
    nxt = {}
    for t, fam, eng in (("tA", "RMAT-G", "sort"), ("tB", "RMAT-ER",
                                                    "bitmap")):
        g = core.rmat.paper_graph(fam, 7, seed=len(t) + ord(t[1]))
        svc.open_stream(t, g, core.ColoringSpec(strategy="recolor",
                                                engine=eng, concurrency=32))
        ds = _deltas(g, 3, 24, seed=ord(t[1]))
        for ins, dels in ds[:2]:
            svc.submit_delta(t, inserts=ins, deletes=dels)
        nxt[t] = ds[2]
    svc.drain()
    svc.checkpoint(str(tmp))
    return svc, nxt


@pytest.mark.parametrize("writer,reader", [("reference", "torch"),
                                           ("torch", "reference")])
def test_service_checkpoint_crosses_packages(writer, reader, tmp_path):
    live, nxt = _stream_service(writer, tmp_path)
    kw = {"device": "cpu"} if reader == "torch" else {}
    back = PKGS[reader][1].AsyncColoringService.restore(
        str(tmp_path), max_batch=4, max_delay_s=0.0, clock=FakeClock(), **kw)
    assert back.stream_tenants == ("tA", "tB")
    a_cum = live.metrics.snapshot()["cumulative"]
    b_cum = back.metrics.snapshot()["cumulative"]
    for key in RESTART_INVARIANT:
        assert a_cum[key] == b_cum[key], key
    for t, (ins, dels) in nxt.items():
        assert back.stream(t).spec.engine == live.stream(t).spec.engine
        np.testing.assert_array_equal(back.stream(t).colors,
                                      live.stream(t).colors)
        for svc in (live, back):
            svc.submit_delta(t, inserts=ins, deletes=dels)
            svc.drain()
        np.testing.assert_array_equal(back.stream(t).colors,
                                      live.stream(t).colors)
        np.testing.assert_array_equal(back.stream(t).graph.undirected_edges(),
                                      live.stream(t).graph.undirected_edges())
        assert T.validate_coloring(
            T.Graph.from_edges(back.stream(t).graph.num_vertices,
                               back.stream(t).graph.undirected_edges()),
            back.stream(t).colors)


def test_checkpoint_guards(tmp_path):
    svc = _svc("torch", FakeClock(), max_delay_s=10.0)
    g = T.rmat.paper_graph("RMAT-G", 6, seed=0)
    svc.open_stream("t0", g, T.ColoringSpec(strategy="recolor"))
    with pytest.raises(ValueError, match="already has"):
        svc.open_stream("t0", g)
    with pytest.raises(ValueError, match="tenant names"):
        svc.open_stream("a/b", g)
    with pytest.raises(KeyError, match="no open stream"):
        svc.submit_delta("t9", inserts=[[0, 1]])
    svc.submit_delta("t0", inserts=[[0, 1]])
    with pytest.raises(RuntimeError, match="in flight"):
        svc.checkpoint(str(tmp_path / "a"))
    svc.drain()
    assert svc.checkpoint(str(tmp_path / "a")) == 0
    tckpt.save(str(tmp_path / "b"), 0, {"streams": {}},
               meta={"schema": 99, "stream_specs": {}})
    with pytest.raises(ValueError, match="schema"):
        TS.AsyncColoringService.restore(str(tmp_path / "b"), device="cpu")
    with pytest.raises(FileNotFoundError):
        TS.AsyncColoringService.restore(str(tmp_path / "none"), device="cpu")


# ------------------------------------------------------------ the worker
def test_worker_thread_serves_requests_and_streams():
    svc = TS.AsyncColoringService(
        default_spec=T.ColoringSpec(engine="fused_pallas", concurrency=16),
        max_batch=3, max_delay_s=0.01, device="cpu")
    gs = _graphs(T, "RMAT-G", 6, range(5))
    svc.open_stream("S", gs[0], T.ColoringSpec(strategy="recolor",
                                               engine="fused_pallas"))
    svc.start()
    try:
        with pytest.raises(RuntimeError, match="already started"):
            svc.start()
        hs = [svc.submit(g, tenant=f"t{i % 2}") for i, g in enumerate(gs)]
        hd = svc.submit_delta("S", *_deltas(gs[0], 1, 16)[0])
        for g, h in zip(gs, hs):
            r = h.result(timeout=60)
            assert T.validate_coloring(g, r.report.colors)
            np.testing.assert_array_equal(
                r.report.colors,
                T.color(g, svc.default_spec, device="cpu").colors)
        assert hd.result(timeout=60).kind == "delta"
    finally:
        svc.stop()
    assert svc.backlog == 0
    dyn = svc.stream("S")
    assert T.validate_coloring(dyn.graph, dyn.colors)
    assert sum(svc.metrics.snapshot()["cumulative"]["flush_reasons"]
               .values()) >= 2


def test_cli_smoke_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.serve", "--smoke", "--device",
         "cpu", "--checkpoint-dir", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "bit-identical colors=True" in out.stdout
    assert "device=cpu" in out.stdout
