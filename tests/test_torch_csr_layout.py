"""repro_torch.core.graph.csr_layout on the CPU (what ``Graph.to_device``
runs on every device) against a numpy oracle that walks the rows one by
one, on R-MAT graphs and the layout's edge cases (isolated vertices, runs
of empty rows, an empty last row, a row of 10,000 edges, no vertex, no
edge), padded or not, with no ELL width, the max degree, or a width below
it. Plus its input checks. On the card, ``tests/test_torch_cuda.py`` holds
a plan's layout to the CPU's."""
import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.core.graph import csr_layout

INT32_MAX = np.iinfo(np.int32).max


def _degrees():
    rng = np.random.default_rng(7)
    sparse = np.where(rng.random(20_000) < 0.01,
                      rng.integers(1, 300, 20_000), 0)
    return {
        "RMAT-ER": np.diff(T.rmat.paper_graph("RMAT-ER", 8, seed=2).row_ptr),
        "RMAT-G": np.diff(T.rmat.paper_graph("RMAT-G", 8, seed=2).row_ptr),
        "isolated": np.array([0, 2, 1, 3, 2, 0, 1, 1, 0, 1, 0, 0]),
        "sparse": sparse,
        "star": np.array([0, 10_000, 0, 3]),
        "V0": np.zeros(0, np.int64),
        "E0": np.zeros(5, np.int64),
    }


DEGREES = _degrees()
CASES = [(g, pad, width) for g in DEGREES for pad in (False, True)
         for width in (None, "max", "half")]


def _row_ptr(graph) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(DEGREES[graph])]).astype(np.int64)


def _width(row_ptr, width):
    d = int(np.diff(row_ptr).max()) if row_ptr.size > 1 else 0
    return {None: None, "max": max(1, d), "half": max(1, d // 2)}[width]


def _oracle(row_ptr, num_padded, width):
    """(src, slot, dst padding, inc_ptr), row by row."""
    V, e = row_ptr.size - 1, int(row_ptr[-1])
    src = np.full(num_padded, V, np.int64)
    slot = np.full(num_padded, width or 0, np.int64)
    for r in range(V):
        a, b = int(row_ptr[r]), int(row_ptr[r + 1])
        src[a:b] = r
        if width is not None:
            slot[a:b] = np.minimum(np.arange(b - a), width)
    return src, slot, np.full(num_padded - e, V), row_ptr.copy()


@pytest.mark.parametrize("graph,pad,width", CASES,
                         ids=[f"{g}-{'pad' if p else 'nopad'}-{w or 'noell'}"
                              for g, p, w in CASES])
def test_csr_layout_plain_matches_numpy_oracle(graph, pad, width):
    row_ptr = _row_ptr(graph)
    e = int(row_ptr[-1])
    num_padded = T.pad_bucket(max(1, e)) if pad else e
    w = _width(row_ptr, width)
    dst = torch.full((num_padded,), -1, dtype=torch.int32)
    dst[:e] = torch.arange(e, dtype=torch.int32)  # stands in for col_idx
    out = csr_layout(torch.from_numpy(row_ptr), dst, e, w)
    src, slot, tail, inc = _oracle(row_ptr, num_padded, w)
    assert out.src.dtype == torch.int32
    np.testing.assert_array_equal(out.src.numpy(), src)
    if w is None:
        assert out.ell_slot is None
    else:
        assert out.ell_slot.dtype == torch.int32
        np.testing.assert_array_equal(out.ell_slot.numpy(), slot)
    np.testing.assert_array_equal(dst[:e].numpy(), np.arange(e))
    np.testing.assert_array_equal(dst[e:].numpy(), tail)
    assert out.inc_ptr.dtype == torch.int32
    np.testing.assert_array_equal(out.inc_ptr.numpy(), inc)


def test_csr_layout_rejects_what_the_kernel_does_not_take():
    row_ptr = torch.from_numpy(_row_ptr("isolated"))
    e = int(row_ptr[-1])
    dst = torch.zeros(e, dtype=torch.int32)
    with pytest.raises(ValueError, match="int64"):
        csr_layout(row_ptr.to(torch.int32), dst, e)
    with pytest.raises(ValueError, match="int32"):
        csr_layout(row_ptr, dst.to(torch.int64), e)
    with pytest.raises(ValueError, match="do not fit"):
        csr_layout(row_ptr, dst[:-1], e)
    with pytest.raises(ValueError, match="ell_width"):
        csr_layout(row_ptr, dst, e, 0)
    with pytest.raises(ValueError, match="contiguous"):
        csr_layout(row_ptr, torch.zeros(2 * e, dtype=torch.int32)[::2], e)
