"""repro_torch kernels: each plain PyTorch version against the reference's
Pallas kernel (interpret mode, small block shapes), over the edge cases the
CUDA kernels must also hold — ragged V, D=1, W=1, W=8, W=9 and W=63, full
rows (INT32_MAX), negative and >= 32*W colors, strided sink-column views
(D=39 at the main path's stride of 40) — plus
the wrappers' routing and checks, and the build's wiring. Exact equality
throughout: the functions are integer-valued. The CUDA kernels themselves
are held against the plain versions on a card (tests/test_torch_cuda.py,
chip_smoke.py)."""
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import conflict_mask as ref_conflict_mask
from repro.kernels import firstfit as ref_firstfit
from repro.kernels import pack_entries as ref_pack_entries
from repro.kernels import round_fused as ref_round_fused
from repro_torch.kernels import (COLOR_MASK, CONFLICT_BIT, FORBID_BIT,
                                 KERNELS, conflict_mask, conflict_mask_plain,
                                 firstfit, firstfit_plain,
                                 launch_counts, pack_entries, round_fused,
                                 round_fused_plain)
from repro_torch.kernels import _build

REPO = Path(__file__).resolve().parents[1]
INT32_MAX = np.iinfo(np.int32).max


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the graphs here are tiny: intra-op threads only contend with the
    # other test workers
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _full_rows(rng, v, d, words):
    """Random slab whose first rows hold every color 1..32*words-1."""
    x = rng.integers(-3, 32 * words + 7, size=(v, d)).astype(np.int32)
    n = 32 * words - 1
    for r in range(min(v, 4)):
        x[r, :n] = rng.permutation(np.arange(1, n + 1))
    return x


def _slab(case):
    """(slab, words, block_d) for each edge case."""
    rng = np.random.default_rng(len(case))
    if case == "ragged":
        return rng.integers(-5, 73, size=(37, 9)).astype(np.int32), 2, 8
    if case == "D=1":
        return rng.integers(-2, 40, size=(13, 1)).astype(np.int32), 1, 8
    if case == "W=1 full rows":
        return _full_rows(rng, 21, 31, 1), 1, 8
    if case == "W=63 full rows":
        return _full_rows(rng, 18, 2048, 63), 63, 128
    if case == "out of range":
        return rng.integers(-100, 196, size=(50, 12)).astype(np.int32), 3, 8
    if case == "one row":
        return rng.integers(0, 40, size=(1, 33)).astype(np.int32), 2, 8
    if case == "W=8 full rows":   # the last register-bitset width
        return _full_rows(rng, 20, 300, 8), 8, 128
    if case == "W=9 full rows":   # the first shared-bitset width
        return _full_rows(rng, 20, 300, 9), 9, 128
    if case == "D=39 sink view":  # the main path's width and stride 40
        return rng.integers(-3, 70, size=(70, 39)).astype(np.int32), 2, 8
    raise KeyError(case)


CASES = ["ragged", "D=1", "W=1 full rows", "W=63 full rows", "out of range",
         "one row", "W=8 full rows", "W=9 full rows", "D=39 sink view"]


def _sink_view(x: np.ndarray) -> torch.Tensor:
    """The [:V, :D] view of a (V+1, D+1) slab, as the engines pass it."""
    v, d = x.shape
    buf = torch.full((v + 1, d + 1), 7, dtype=torch.int32)
    buf[:v, :d] = torch.tensor(x)
    return buf[:v, :d]


@pytest.mark.parametrize("case", CASES)
def test_firstfit_plain_matches_reference(case):
    x, words, bd = _slab(case)
    want = np.asarray(ref_firstfit(jnp.asarray(x), words=words, block_v=16,
                                   block_d=bd, interpret=True))
    got = firstfit(_sink_view(x), words=words).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        firstfit_plain(torch.from_numpy(x), words=words).numpy(), want)
    if "full rows" in case:
        assert (want[:4] == INT32_MAX).all()


def _packed(x, seed):
    rng = np.random.default_rng(seed)
    forbid = rng.random(x.shape) < 0.6
    elig = rng.random(x.shape) < 0.3
    own = np.where(rng.random(x.shape[0]) < 0.5, x[:, 0] & COLOR_MASK,
                   rng.integers(0, 200, x.shape[0])).astype(np.int32)
    return forbid, elig, own


@pytest.mark.parametrize("case", CASES)
def test_round_fused_plain_matches_reference(case):
    x, words, bd = _slab(case)
    forbid, elig, own = _packed(x, len(case))
    ent = np.asarray(ref_pack_entries(jnp.asarray(x), jnp.asarray(forbid),
                                      jnp.asarray(elig)))
    ent_t = pack_entries(torch.from_numpy(x), torch.from_numpy(forbid),
                         torch.from_numpy(elig))
    np.testing.assert_array_equal(ent_t.numpy(), ent)
    wm, wc = ref_round_fused(jnp.asarray(ent), jnp.asarray(own), words=words,
                             block_v=16, block_d=bd, interpret=True)
    gm, gc = round_fused(_sink_view(ent), torch.from_numpy(own), words=words)
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))


def test_round_fused_conflict_lane_fires():
    """The conflict lane: a CONFLICT entry equal to the row's own color > 0
    fires; FORBID-only ties and uncolored rows never do."""
    ent = torch.tensor([[5 | CONFLICT_BIT, 0], [5 | FORBID_BIT, 0],
                        [0 | CONFLICT_BIT, 0], [3 | CONFLICT_BIT | FORBID_BIT, 1]],
                       dtype=torch.int32)
    own = torch.tensor([5, 5, 0, 3], dtype=torch.int32)
    mex, conf = round_fused(ent, own, words=1)
    assert conf.tolist() == [1, 0, 0, 1]
    assert mex.tolist() == [1, 1, 1, 1]
    mex, _ = round_fused_plain(ent | FORBID_BIT, own, words=1)
    assert mex.tolist() == [1, 1, 1, 2]


@pytest.mark.parametrize("e", [1, 1000, 5000])
def test_conflict_mask_plain_matches_reference(e):
    rng = np.random.default_rng(e)
    arrs = [rng.integers(-3, 8, e).astype(np.int32),
            rng.integers(-3, 8, e).astype(np.int32),
            rng.integers(0, 100, e).astype(np.int32),
            rng.integers(0, 100, e).astype(np.int32)]
    want = np.asarray(ref_conflict_mask(*map(jnp.asarray, arrs),
                                        block_e=128, interpret=True))
    got = conflict_mask(*map(torch.from_numpy, arrs)).numpy()
    np.testing.assert_array_equal(got, want)


def test_cpu_tensors_never_count_launches():
    before = launch_counts()
    x = torch.ones((4, 3), dtype=torch.int32)
    firstfit(x, words=1)
    round_fused(x, torch.zeros(4, dtype=torch.int32), words=1)
    conflict_mask(*(torch.zeros(5, dtype=torch.int32),) * 4)
    assert launch_counts() == before


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros((4, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        firstfit(x.to(torch.int64), words=1)
    with pytest.raises(ValueError, match="stride"):
        firstfit(torch.zeros((3, 4), dtype=torch.int32).t(), words=1)
    with pytest.raises(ValueError, match="shared memory"):
        firstfit(x, words=60000)
    with pytest.raises(ValueError, match="own_colors"):
        round_fused(x, torch.zeros(3, dtype=torch.int32), words=1)
    with pytest.raises(ValueError, match="int32"):
        conflict_mask(torch.zeros(5, dtype=torch.int32),
                      torch.zeros(5, dtype=torch.int32),
                      torch.zeros(5, dtype=torch.int64),
                      torch.zeros(5, dtype=torch.int32))


def test_kernel_registry_names_sources_and_pallas_calls():
    """Every kernel names its CUDA source and the reference line that holds
    the ``pl.pallas_call`` it replaces."""
    assert [k.name for k in KERNELS] == ["firstfit", "round_fused",
                                         "conflict_mask"]
    for k in KERNELS:
        assert (REPO / k.source).exists(), k.source
        path, line = k.replaces.split(":")
        text = (REPO / path).read_text().splitlines()[int(line) - 1]
        assert "pl.pallas_call" in text, (k.name, text)
        assert k.wrapper.launches >= 0


def test_build_targets_hopper_from_the_sources():
    names = {p.name for p in _build.sources()}
    assert {"firstfit.cu", "round_fused.cu", "conflict.cu"} <= names
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    path = _build.library_path()
    assert path.parent == REPO / "build" / "kernels"
    assert _build.source_hash() in path.name
