"""A stream of edge batches in the benchmark, on the CPU: the plain delta
against the program's own, the seeded batch maker, the judge along a chain
of continued answers, the test sizes of every request scale, and a whole
run and control of a stream cell whose files are all written outside the
benchmark's folder, which passes every per-cell check the benchmark's
tests apply to its own cells (so that such a cell needs only new files and
entries)."""
import copy
import gc
import json
import textwrap
import types

import numpy as np
import pytest
import torch

from portbench import cell_checks, gen, harness, plain
from portbench.conftest import small

CPU = torch.device("cpu")
BENCH = harness.load_bench()
ER = {"edge_factor": 8, "params": [0.25, 0.25, 0.25, 0.25]}
B = {"edge_factor": 8, "params": [0.55, 0.15, 0.15, 0.15]}
SEED = 2**31 + 29


def _edges(csr):
    src = np.repeat(np.arange(csr.num_vertices), np.diff(csr.row_ptr))
    return src, csr.col_idx.astype(np.int64)


def _keys(csr):
    src, dst = _edges(csr)
    return set((src * csr.num_vertices + dst).tolist())


# --------------------------------------------------------------------------
# plain.apply_delta against the program's Graph.delta_info
# --------------------------------------------------------------------------
def _messy_delta(csr, rng):
    """Inserts and deletes with repeats, self-loops, inserts of present
    edges, deletes of absent ones, and pairs in both lists, in either
    orientation."""
    n = csr.num_vertices
    src, dst = _edges(csr)
    present = np.stack([src, dst], 1)[rng.choice(src.size, 24)]
    fresh = rng.integers(0, n, (24, 2))
    loops = np.repeat(rng.integers(0, n, (4, 1)), 2, 1)
    both = np.concatenate([present[:5], fresh[:5]])
    ins = np.concatenate([fresh, present[:8], loops, fresh[:6], both])
    dels = np.concatenate([present, fresh[12:], loops, present[:4, ::-1],
                           both[:, ::-1]])
    return rng.permutation(ins), rng.permutation(dels)


@pytest.mark.parametrize("case", range(6))
def test_apply_delta_equals_the_programs_delta_info(case):
    from repro_torch.core import Graph
    (csr,) = gen.make_pool(B if case % 2 else ER, 8, 1, 500 + case, CPU)
    rng = np.random.default_rng(case)
    ins, dels = _messy_delta(csr, rng)
    if case == 4:
        ins = None
    if case == 5:
        dels = np.zeros((0, 2), np.int64)
    got = plain.apply_delta(csr, ins, dels, CPU)
    want, _, _ = Graph(csr.num_vertices, csr.row_ptr,
                       csr.col_idx).delta_info(ins, dels)
    assert got.num_vertices == csr.num_vertices
    assert got.row_ptr.dtype == np.int64 and got.col_idx.dtype == np.int32
    assert np.array_equal(got.row_ptr, want.row_ptr)
    assert np.array_equal(got.col_idx, want.col_idx)


def test_apply_delta_set_semantics_on_a_path():
    # 0-1-2-3; delete 1-2 and 0-3 (absent), insert 0-2, 2-1 (in both), 3-3
    csr = gen.Csr(4, np.array([0, 1, 3, 5, 6]),
                  np.array([1, 0, 2, 1, 3, 2], np.int32))
    got = plain.apply_delta(csr, [[0, 2], [2, 1], [3, 3], [2, 0]],
                            [[1, 2], [0, 3]], CPU)
    assert _keys(got) == {0 * 4 + 1, 1 * 4 + 0, 0 * 4 + 2, 2 * 4 + 0,
                          1 * 4 + 2, 2 * 4 + 1, 2 * 4 + 3, 3 * 4 + 2}
    with pytest.raises(ValueError):
        plain.apply_delta(csr, [[0, 4]], None, CPU)
    with pytest.raises(ValueError):
        plain.apply_delta(csr, None, [[-1, 2]], CPU)


def test_stale_ends_are_the_new_edges_of_one_color():
    # 0-1 before; 1-2 (both color 2) and 2-3 (2, 1) new; 0-1 (1, 2) old
    before = gen.Csr(4, np.array([0, 1, 2, 2, 2]), np.array([1, 0], np.int32))
    after = plain.apply_delta(before, [[1, 2], [3, 2]], None, CPU)
    got = plain.stale_ends(plain.to_device(after, CPU),
                           plain.to_device(before, CPU),
                           np.array([1, 2, 2, 1], np.int32))
    assert got.tolist() == [False, True, True, False]
    same = plain.to_device(before, CPU)
    assert not plain.stale_ends(same, same, np.ones(4, np.int32)).any()


# --------------------------------------------------------------------------
# the batch maker
# --------------------------------------------------------------------------
def _batch(csr, step, seed=SEED, inserts=96, deletes=40, chain=0):
    return gen.edge_batch(csr, inserts, deletes, seed, chain, step, CPU)


def test_edge_batch_same_seed_same_batches():
    (csr,) = gen.make_pool(ER, 9, 1, 11, CPU)
    a, b = _batch(csr, 3), _batch(csr, 3)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    for other in (_batch(csr, 4), _batch(csr, 3, seed=SEED + 1),
                  _batch(csr, 3, chain=1)):
        assert not np.array_equal(a[0], other[0])
        assert not np.array_equal(a[1], other[1])


@pytest.mark.parametrize("inserts,deletes", [(96, 40), (0, 7), (5, 0),
                                             (1, 10**6)])
def test_edge_batch_counts_and_present_deletes(inserts, deletes):
    (csr,) = gen.make_pool(ER, 9, 1, 12, CPU)
    ins, dels = _batch(csr, 0, inserts=inserts, deletes=deletes)
    n, undirected = csr.num_vertices, csr.num_directed_edges // 2
    assert ins.shape == (inserts, 2) and ins.dtype == np.int64
    assert dels.shape == (min(deletes, undirected), 2)
    assert dels.dtype == np.int64
    assert ((0 <= ins) & (ins < n)).all()
    present = _keys(csr)
    keys = dels[:, 0] * n + dels[:, 1]
    assert (dels[:, 0] < dels[:, 1]).all()
    assert set(keys.tolist()) <= present
    assert np.unique(keys).size == keys.size                  # distinct


def test_edge_batch_follows_the_graph_along_a_chain():
    # each batch's deletes are edges present after the batches before it;
    # the vertex set stays
    (csr,) = gen.make_pool(ER, 9, 1, 13, CPU)
    for step in range(4):
        ins, dels = _batch(csr, step)
        present = _keys(csr)
        assert set((dels[:, 0] * 512 + dels[:, 1]).tolist()) <= present
        nxt = plain.apply_delta(csr, ins, dels, CPU)
        assert nxt.num_vertices == 512 and nxt.row_ptr.shape == (513,)
        gone = set((dels[:, 0] * 512 + dels[:, 1]).tolist())
        back = set((ins[:, 0] * 512 + ins[:, 1]).tolist()) | set(
            (ins[:, 1] * 512 + ins[:, 0]).tolist())
        assert not (gone - back) & _keys(nxt)
        csr = nxt


def test_edge_batch_inserts_are_uniform_over_the_vertices():
    # whatever the graph's skew: on R-MAT-B the top 2 % of vertices by
    # degree hold ~18 % of the edge ends, but take ~2 % of the inserts' ends;
    # a graph of any vertex count takes a batch
    (csr,) = gen.make_pool(B, 11, 1, 14, CPU)
    ins, _ = _batch(csr, 0, inserts=8192, deletes=0)
    deg = np.diff(csr.row_ptr)
    hubs = np.argsort(deg)[-len(deg) // 50:]
    assert deg[hubs].sum() / deg.sum() > 0.1
    assert 0.01 < np.isin(ins, hubs).mean() < 0.03
    assert np.bincount(ins.ravel(), minlength=2048).max() < 40
    odd = gen.Csr(3, np.array([0, 1, 2, 2]), np.array([1, 0], np.int32))
    ins, dels = _batch(odd, 0, inserts=50, deletes=3)
    assert set(np.unique(ins).tolist()) == {0, 1, 2}
    assert dels.tolist() == [[0, 1]]


# --------------------------------------------------------------------------
# the judge along a chain
# --------------------------------------------------------------------------
CONCURRENCY = 8


class Tracked(plain.Answer):
    """An answer the test's reference made, counted while it is alive: the
    judge may hold one state a chain at a time."""

    alive = 0

    def __new__(cls, *args):
        Tracked.alive += 1
        return super().__new__(cls, *args)

    def __del__(self):
        Tracked.alive -= 1


def _local_reference():
    """ITERATIVE from the cold start, then each batch's repair of the
    previous state (the test's reference)."""
    def reference(g, config):
        return Tracked(*plain.iterative(g, CONCURRENCY))

    def reference_after(g, config, before, prev):
        assert Tracked.alive <= config["chains"]   # a predecessor a chain
        return Tracked(*plain.iterative(
            g, CONCURRENCY, colors=prev.colors,
            pending=plain.stale_ends(g, before, prev.colors)))
    return types.SimpleNamespace(reference=reference,
                                 reference_after=reference_after)


def _chain(csr, chain, steps, stride=1, first=0):
    """A correct chain on ``csr`` whose answers sit every ``stride``
    positions from ``first`` of the run's answers, and the reference's
    graph and answer at each step (cold start included)."""
    want = plain.iterative(plain.to_device(csr, CPU), CONCURRENCY)
    answers = [harness.Answered(chain, want.colors, want.conflicts_per_round,
                                0.0)]
    states = [(csr, want)]
    for step in range(steps):
        ins, dels = _batch(csr, step, chain=chain)
        nxt = plain.apply_delta(csr, ins, dels, CPU)
        g = plain.to_device(nxt, CPU)
        want = plain.iterative(g, CONCURRENCY, colors=want.colors,
                               pending=plain.stale_ends(
                                   g, plain.to_device(csr, CPU), want.colors))
        answers.append(harness.Answered(
            chain, want.colors, want.conflicts_per_round, 0.0,
            after=first + stride * (len(answers) - 1), inserts=ins,
            deletes=dels))
        states.append((nxt, want))
        csr = nxt
    return answers, states


def _judge(csrs, answers, setup=(), ref=None, chains=1):
    gc.collect()
    Tracked.alive = 0
    ref = ref or _local_reference()
    return harness.judge(ref, {"chains": chains}, csrs, answers, CPU,
                         setup)


def _values(checks):
    return {k: c["value"] for k, c in checks.items()}


def _zero():
    return {"wrong_colors": 0, "bad_edges": 0, "wrong_histories": 0,
            "unanswered": 0}


@pytest.fixture(scope="module")
def toy():
    (csr,) = gen.make_pool(ER, 7, 1, 15, CPU)
    answers, states = _chain(csr, 0, 4)
    # every batch leaves edges to repair, so a stale answer shows
    for (g0, w0), (g1, _) in zip(states, states[1:]):
        assert plain.stale_ends(plain.to_device(g1, CPU),
                                plain.to_device(g0, CPU), w0.colors).any()
    return csr, answers, states


def test_a_correct_chain_reads_zero(toy):
    csr, answers, _ = toy
    assert _values(_judge([csr], answers)) == _zero()


@pytest.mark.parametrize("at", [1, 3, 4])
def test_an_unrepaired_answer_is_caught(toy, at):
    # the answer hands back the colors before its batch
    csr, answers, _ = toy
    answers = list(answers)
    answers[at] = answers[at]._replace(colors=answers[at - 1].colors)
    got = _values(_judge([csr], answers))
    assert got["wrong_colors"] > 0 and got["bad_edges"] > 0
    assert got["unanswered"] == 0


@pytest.mark.parametrize("at", [1, 2, 4])
def test_an_answer_recolored_from_scratch_is_caught(toy, at):
    # a valid coloring of the right graph, but not the repair the previous
    # state defines
    csr, answers, states = toy
    cold = plain.iterative(plain.to_device(states[at][0], CPU), CONCURRENCY)
    answers = list(answers)
    answers[at] = answers[at]._replace(colors=cold.colors,
                                       conflicts_per_round=cold.
                                       conflicts_per_round)
    got = _values(_judge([csr], answers))
    assert got["wrong_colors"] > 0 and got["wrong_histories"] == 1
    assert got["bad_edges"] == 0 and got["unanswered"] == 0


def test_a_wrong_record_is_caught(toy):
    # the program applied other changes than it says: its colors do not fit
    # the graph the records build
    csr, answers, _ = toy
    answers = list(answers)
    answers[2] = answers[2]._replace(inserts=None)
    assert _values(_judge([csr], answers))["wrong_colors"] > 0


@pytest.mark.parametrize("broken", ["dropped", "later", "negative", "self"])
def test_a_chain_without_its_predecessor_is_unanswered(toy, broken):
    # answer 2's predecessor is not handed to the judge, or not earlier:
    # it and the two that continue it count as unanswered, not judged
    csr, answers, _ = toy
    answers = list(answers)
    if broken == "dropped":
        answers[1] = harness.Answered(-1, None, None, None, "lost")
    else:
        answers[2] = answers[2]._replace(
            after={"later": 3, "negative": -1, "self": 2}[broken])
    got = _values(_judge([csr], answers))
    assert got == dict(_zero(), unanswered=4 if broken == "dropped" else 3)


def test_a_configuration_that_cannot_judge_a_continued_state(toy):
    csr, answers, _ = toy
    ref = types.SimpleNamespace(
        reference=lambda g, config: plain.iterative(g, CONCURRENCY))
    got = _values(_judge([csr], answers, ref=ref))
    assert got == dict(_zero(), unanswered=4)


def test_set_up_answers_are_judged_with_the_rest(toy):
    # the cold start and the warm batch handed as set-up answers: the
    # window's first answer continues position 1
    csr, answers, _ = toy
    assert _values(_judge([csr], answers[2:], setup=answers[:2])) == _zero()
    stale = answers[1]._replace(colors=answers[0].colors)
    got = _values(_judge([csr], answers[2:], setup=[answers[0], stale]))
    assert got["wrong_colors"] > 0 and got["unanswered"] == 0


def test_two_chains_interleaved_keep_a_state_each():
    # two pool graphs, each with its own chain, their answers interleaved;
    # the reference checks that at most one state a chain is alive
    csrs = gen.make_pool(ER, 7, 2, 16, CPU)
    a, _ = _chain(csrs[0], 0, 3, stride=2, first=0)
    b, _ = _chain(csrs[1], 1, 3, stride=2, first=1)
    seq = [x for pair in zip(a, b) for x in pair]
    assert _values(_judge(csrs, seq, chains=2)) == _zero()
    seq[5] = seq[5]._replace(colors=seq[3].colors)         # b's second batch
    got = _values(_judge(csrs, seq, chains=2))
    assert got["wrong_colors"] > 0 and got["unanswered"] == 0


# --------------------------------------------------------------------------
# test sizes
# --------------------------------------------------------------------------
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_small_keeps_the_cells_test_sizes(cell):
    cell_checks.sizes(BENCH, cell)


# --------------------------------------------------------------------------
# a stream cell made of new files only
# --------------------------------------------------------------------------
TOY_REFERENCE = '''
"""Plain reference of a throwaway stream configuration: ITERATIVE from the
cold start, then each batch's repair from the previous state."""
from portbench import plain


def _p(config):
    return int(config["spec"]["concurrency"])


def reference(g, config):
    return plain.iterative(g, _p(config))


def control(g, config):
    return plain.iterative(g, _p(config), repair=False)


def reference_after(g, config, before, prev):
    return plain.iterative(g, _p(config), colors=prev.colors,
                           pending=plain.stale_ends(g, before, prev.colors))


def control_after(g, config, before, prev):
    return plain.iterative(g, _p(config), repair=False, colors=prev.colors,
                           pending=plain.stale_ends(g, before, prev.colors))
'''

TOY_DRIVER = '''
"""A throwaway stream driver: DynamicColoring on the pool's first graph, a
cold start and one warm batch in set-up, then one batch after another. Each
batch is drawn from the harness's own chain, a function of the seed alone;
``color_s`` is the batches' own time, the drawing left out."""
import time

import numpy as np

from portbench import gen, plain
from portbench.harness import Answered, Window


def _step(cell, st):
    b = cell.traffic["batch"]
    ins, dels = gen.edge_batch(st["csr"], b["inserts"], b["deletes"],
                               cell.seed, 0, st["step"], cell.device)
    t = time.perf_counter()
    rep = st["dyn"].apply_batch(ins, dels)
    colors = st["dyn"].colors.copy()
    lat = time.perf_counter() - t
    st["csr"] = plain.apply_delta(st["csr"], ins, dels, cell.device)
    st["step"] += 1
    hist = (rep.report.conflicts_per_round if rep.report is not None
            else np.zeros(0, np.int32))
    return Answered(0, colors, hist, lat, after=st["made"] - 1,
                    inserts=ins, deletes=dels)


def setup(cell):
    from repro_torch.core import ColoringSpec
    from repro_torch.core.dynamic import DynamicColoring
    dyn = DynamicColoring(cell.program_graphs[0],
                          ColoringSpec(**cell.config["spec"]),
                          device=cell.device)
    cold = dyn.recolor_full()
    st = {"dyn": dyn, "csr": cell.csrs[0], "step": 0, "made": 1,
          "setup": [Answered(0, cold.colors, cold.conflicts_per_round, None)]}
    st["setup"].append(_step(cell, st))
    st["made"] += 1
    return st


def window(cell, st, seconds):
    answers = []
    t0 = time.perf_counter()
    while True:
        answers.append(_step(cell, st))
        st["made"] += 1
        if time.perf_counter() - t0 >= seconds:
            break
    span = time.perf_counter() - t0
    busy = sum(a.latency_s for a in answers)
    return Window(seconds=span, graphs=len(answers), answers=answers,
                  values={"color_s": busy / len(answers)},
                  setup_answers=st["setup"])


def close(cell, st):
    """Nothing runs after the window."""
'''

TOY_READER = '''
"""Batches colored in the window (a throwaway reader)."""


def read(ctx):
    return float(ctx.window.requests) or None
'''


TOY_CELL = "toy.stream"


@pytest.fixture
def stream_bench(tmp_path, monkeypatch):
    """``BENCHMARK.json`` with a stream cell added as a later change adds
    one: its configuration, reference, traffic, driver and a reader in a new
    layer as new files, outside the benchmark's folder (with copies of the
    readers its ``.stream`` metrics resolve to), and entries that carry
    every key a real entry carries."""
    er = harness.load_json("configs", "rmat-er.iterative")
    config = dict(er, name="toy.stream-config",
                  scale={"oneshot": 22, "served": 19, "stream": 20},
                  spec=dict(er["spec"], strategy="recolor", concurrency=8))
    traffic = {"name": "toy-stream", "driver": "toy_stream",
               "request_scale": "stream", "pool": 1,
               "batch": {"inserts": 65536, "deletes": 16384, "chain": 3}}
    bench = copy.deepcopy(BENCH)
    bench["configs"].append({
        "name": config["name"], "source": er["source"],
        "file": f"portbench/configs/{config['name']}.json",
        "reduced": sorted(er["reduced"]),
        "why": "a throwaway stream: recolor warm starts from committed "
               "colors and a seed set of each batch's new conflicts"})
    bench["workloads"].append({
        "name": TOY_CELL, "config": config["name"], "traffic": "toy-stream",
        "chips": 1, "why": "1 caller, one live RMAT-ER graph, batches of "
                           "inserts and deletes one after another"})
    for m in bench["end_to_end"]:
        if m["name"] == "color_s":
            m["workloads"].append(TOY_CELL)
    bench["per_layer"].append({
        "name": "toy_batches", "unit": "batches", "better": "higher",
        "source": "program_counter", "layer": "toy delta step",
        "moves": "color_s", "workloads": [TOY_CELL]})
    # the .stream span metrics: the cell joins an entry that is there, or
    # brings its own
    for name, layer in (("layout_ms_per_graph.stream", "plan and host layout"),
                        ("sync_wait_ms_per_graph.stream", "round loop")):
        have = [m for m in bench["per_layer"] if m["name"] == name]
        if not have:
            have = [{"name": name, "unit": "ms/graph", "better": "lower",
                     "source": "program_span", "layer": layer,
                     "moves": "color_s", "workloads": []}]
            bench["per_layer"] += have
        have[0].get("workloads", []).append(TOY_CELL)
    files = {"configs/toy.stream-config.json": json.dumps(config),
             "configs/toy.stream-config.py": TOY_REFERENCE,
             "traffic/toy-stream.json": json.dumps(traffic),
             "drivers/toy_stream.py": TOY_DRIVER,
             "metrics/toy_batches.py": TOY_READER}
    for m in harness.metrics_of(bench, "per_layer", TOY_CELL):
        if m["name"] != "toy_batches":
            path = harness.reader_path(m["name"])
            files[f"metrics/{path.name}"] = path.read_text()
    for rel, text in files.items():
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(text))
    monkeypatch.setattr(harness, "HERE", tmp_path)
    return bench


def test_small_shrinks_every_request_scale(stream_bench):
    config, traffic = small(stream_bench, TOY_CELL)
    assert config["scale"] == {"oneshot": 9, "served": 8, "stream": 9}
    assert traffic["pool"] == 1
    assert traffic["batch"] == {"inserts": 65536 >> 11, "deletes": 16384 >> 11,
                                "chain": 3}
    config, traffic = small(stream_bench, TOY_CELL, scale_oneshot=14,
                            scale_served=12)
    assert config["scale"] == {"oneshot": 14, "served": 12, "stream": 14}
    assert traffic["batch"] == {"inserts": 65536 >> 6, "deletes": 16384 >> 6,
                                "chain": 3}


@pytest.mark.parametrize("traced", [False, True], ids=["trace0", "trace1"])
def test_a_stream_cell_of_new_files_runs_and_is_judged(stream_bench, traced):
    config, traffic = small(stream_bench, TOY_CELL)
    out = harness.run_cell(TOY_CELL, SEED, 0.3, traced, CPU,
                           bench=stream_bench, config=config,
                           traffic=traffic)
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    kind = "toy_batches" if traced else "color_s"
    assert out["metrics"][kind]["value"] > 0
    if traced:
        # the set-up's cold start and warm batch count toward nothing
        assert out["metrics"]["toy_batches"]["value"] == out["attempted"]


GUARD = ["entries", "sizes", "readers_without_spans", "result_line-trace0",
         "result_line-trace1", "span_metrics", "span_table"]


@pytest.mark.parametrize("check", GUARD)
def test_a_stream_cell_of_new_entries_passes_every_per_cell_check(
        stream_bench, check, monkeypatch):
    # every check the tests apply to BENCHMARK.json's cells, on a cell of a
    # traffic kind they have not seen: a request scale of its own, no
    # queue, a new layer among its metrics
    bench, cell = stream_bench, TOY_CELL
    if check == "entries":
        cell_checks.entries(bench, cell)
    elif check == "sizes":
        cell_checks.sizes(bench, cell)
    elif check == "readers_without_spans":
        cell_checks.readers_without_spans(bench, cell, monkeypatch)
    else:
        traced = check != "result_line-trace0"
        out, summary = cell_checks.run_small(bench, cell, SEED, traced, 0.3)
        if check.startswith("result_line"):
            cell_checks.result_line(bench, cell, out, traced)
        elif check == "span_metrics":
            cell_checks.span_metrics(bench, cell, out)
        else:
            cell_checks.span_table(bench, cell, out, summary)


def test_a_stale_stream_answer_is_not_correct(stream_bench, monkeypatch):
    # the program's repair hands back the colors it started from
    from repro_torch.core.dynamic import DynamicColoring
    real = DynamicColoring.apply_batch

    def stale(self, inserts=None, deletes=None):
        before = self.colors
        rep = real(self, inserts, deletes)
        self._colors = before
        return rep

    monkeypatch.setattr(DynamicColoring, "apply_batch", stale)
    config, traffic = small(stream_bench, TOY_CELL)
    out = harness.run_cell(TOY_CELL, SEED, 0.3, False, CPU,
                           bench=stream_bench, config=config,
                           traffic=traffic)
    assert out["correct"] is False
    assert out["checks"]["wrong_colors"]["value"] > 0


def test_a_stream_cells_control_runs_along_its_chain(stream_bench):
    from portbench import control
    config, traffic = small(stream_bench, TOY_CELL)
    checks = control.judged_control(stream_bench, TOY_CELL, SEED, CPU,
                                    config=config, traffic=traffic)
    assert not harness.passed(checks)
    assert checks["wrong_colors"]["value"] > 0
    assert checks["unanswered"]["value"] == 0


@pytest.mark.cuda
def test_a_stream_on_the_card(card, stream_bench):
    # the batch maker and the plain delta on the card: the same batches from
    # the same seed, the program's delta_info's graph, and a whole stream
    # run correct at the card tests' size, its control not
    from repro_torch.core import Graph

    from portbench import control
    (csr,) = gen.make_pool(ER, 14, 1, 17, card)
    batches = [gen.edge_batch(csr, 1024, 256, SEED, 0, 0, card)
               for _ in range(2)]
    assert all(np.array_equal(x, y) for x, y in zip(*batches))
    ins, dels = batches[0]
    got = plain.apply_delta(csr, ins, dels, card)
    want = Graph(csr.num_vertices, csr.row_ptr, csr.col_idx).apply_delta(
        ins, dels)
    assert np.array_equal(got.row_ptr, want.row_ptr)
    assert np.array_equal(got.col_idx, want.col_idx)
    sizes = {"scale_oneshot": 14, "scale_served": 12}
    out, _ = cell_checks.run_small(stream_bench, TOY_CELL, SEED, True, 1.0,
                                   card, **sizes)
    assert out["attempted"] >= 1
    cell_checks.card_run(stream_bench, TOY_CELL, out)
    config, traffic = small(stream_bench, TOY_CELL, **sizes)
    checks = control.judged_control(stream_bench, TOY_CELL, SEED, card,
                                    config=config, traffic=traffic)
    assert not harness.passed(checks)
