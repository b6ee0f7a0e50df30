"""repro_torch.kernels.sorted_mex on the CPU: the plain version (what
``segment_mex`` runs for a CPU tensor), and ``segment_mex`` through it,
against the reference's ``segment_mex`` and a Python mex, on the shapes the
CUDA kernel must get right: an inert sink segment holding most pairs, a
hub of more than 13,000 pairs with holes, every pair a gap, duplicates
only, vertices with no entries, no pair at all. Plus the wrapper's routing
and checks. The CUDA kernel is held against the plain version on a card
(tests/test_torch_cuda.py, chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mex as RM
from repro_torch.core import mex as TM
from repro_torch.kernels import launch_counts, sorted_mex, sorted_mex_plain

INT32_MAX = np.iinfo(np.int32).max
V = 64


def _with_synthetic(v, c, vertices):
    """The pairs plus one (v, 0) for each of ``vertices``, as
    ``SortMexBackend`` appends them."""
    vertices = np.asarray(vertices, np.int64)
    return (np.concatenate([v, vertices]).astype(np.int32),
            np.concatenate([c, np.zeros(vertices.size)]).astype(np.int32))


def _cases():
    rng = np.random.default_rng(27)
    live = rng.integers(0, V, 3_000)
    hub = np.delete(np.arange(14_000), [5_000, 5_001, 9_000, 13_500])
    hub = np.concatenate([hub, rng.choice(hub, 200)])  # and repeats
    return {
        # the inert id V (never a mex of its own) takes most pairs
        "sink": _with_synthetic(
            np.concatenate([live, np.full(20_000, V)]),
            np.concatenate([rng.integers(0, 9, 3_000),
                            rng.integers(0, 9, 20_000)]), range(V)),
        # a hub of 13,996 distinct colors from 0 with four holes
        "hub": _with_synthetic(
            np.concatenate([np.full(hub.size, 5), live]),
            np.concatenate([hub, rng.integers(0, 9, live.size)]), range(V)),
        # 0, 2, 4, ...: every pair a gap, in a hub and a run of ones
        "all-gaps": _with_synthetic(
            np.concatenate([np.full(13_000, 9), np.full(40, 10)]),
            np.concatenate([2 * np.arange(13_000), 1 + 2 * np.arange(40)]),
            range(V)),
        # duplicates only: color 0 many times, and 0 0 1 1 2 2 ...
        "duplicates": _with_synthetic(
            np.concatenate([np.full(5_000, 3), np.full(6_000, 4)]),
            np.concatenate([np.zeros(5_000), np.arange(6_000) // 2]),
            np.repeat(np.arange(V), 3)),
        # odd vertices have no pair: INT32_MAX
        "no-entries": _with_synthetic(
            2 * rng.integers(0, V // 2, 2_000),
            rng.integers(0, 12, 2_000), range(0, V, 2)),
        "empty": (np.zeros(0, np.int32), np.zeros(0, np.int32)),
    }


CASES = _cases()


def _python_mex(v, c):
    """Least positive color absent from each vertex's pairs; INT32_MAX
    without pairs (every vertex with pairs holds color 0 here)."""
    out = np.full(V, INT32_MAX, np.int64)
    for vid in range(V):
        present = set(c[v == vid].tolist())
        if present:
            m = 1
            while m in present:
                m += 1
            out[vid] = m
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_sorted_mex_plain_matches_reference_and_python(case):
    v, c = CASES[case]
    rng = np.random.default_rng(len(v))
    perm = rng.permutation(len(v))
    v, c = v[perm], c[perm]
    want = _python_mex(v, c)
    ref = np.asarray(RM.segment_mex(jnp.asarray(v), jnp.asarray(c), V))
    np.testing.assert_array_equal(ref, want)
    order = np.lexsort((c, v))
    got = sorted_mex_plain(torch.from_numpy(v[order]),
                           torch.from_numpy(c[order]), V)
    assert got.dtype == torch.int32 and got.shape == (V,)
    np.testing.assert_array_equal(got.numpy(), want)
    before = launch_counts()["sorted_mex"]
    through = TM.segment_mex(torch.from_numpy(v), torch.from_numpy(c), V)
    assert launch_counts()["sorted_mex"] == before
    np.testing.assert_array_equal(through.numpy(), want)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    v, c = CASES["sink"]
    order = np.lexsort((c, v))
    vs, cs = torch.from_numpy(v[order]), torch.from_numpy(c[order])
    before = launch_counts()["sorted_mex"]
    got = sorted_mex(vs, cs, V)
    TM.segment_mex(torch.from_numpy(v), torch.from_numpy(c), V)
    assert launch_counts()["sorted_mex"] == before
    assert torch.equal(got, sorted_mex_plain(vs, cs, V))


def test_sorted_mex_rejects_what_the_kernel_does_not_take():
    v = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        sorted_mex(v.long(), v, 4)
    with pytest.raises(ValueError, match="int32"):
        sorted_mex(v, v.float(), 4)
    with pytest.raises(ValueError, match="contiguous"):
        sorted_mex(torch.zeros(16, dtype=torch.int32)[::2], v, 4)
    with pytest.raises(ValueError, match="colors"):
        sorted_mex(v, v[:-1], 4)
    with pytest.raises(ValueError, match="num_vertices"):
        sorted_mex(v, v, INT32_MAX)
    with pytest.raises(ValueError, match="num_vertices"):
        sorted_mex(v, v, -1)
