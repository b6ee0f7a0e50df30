"""Carry state across from the reference package.

The coloring system has no weights: its state is the graph. These functions
rebuild the port's containers from the numpy arrays of the reference's
(``repro.core.graph``) containers, so both packages can color the identical
device layout. They take plain arrays, never reference objects: the port
does not import the reference.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .core.graph import (BipartiteGraph, DeviceGraph, DeviceSpec, Graph,
                         resolve_device)

_ARRAY_FIELDS = ("src", "dst", "row_ptr", "col_idx", "ell_slot", "inc_ptr")
_STATIC_FIELDS = ("num_vertices", "num_directed_edges", "max_degree",
                  "ell_width")


def device_graph_from_arrays(fields: Mapping, device: DeviceSpec = None) -> DeviceGraph:
    """A :class:`DeviceGraph` on ``device`` (``None`` = the card) from the
    fields of a reference ``DeviceGraph``: the arrays ``src``, ``dst`` and
    optionally ``row_ptr``, ``col_idx``, ``ell_slot``, ``inc_ptr`` (numpy
    or anything ``np.asarray`` takes; absent or ``None`` = layout not
    present), and the statics ``num_vertices``, ``num_directed_edges``,
    ``max_degree``, ``ell_width``."""
    dev = resolve_device(device)
    kw = {}
    for name in _ARRAY_FIELDS:
        a = fields.get(name)
        kw[name] = (None if a is None else
                    torch.from_numpy(np.array(a, dtype=np.int32)).to(dev))
    for name in _STATIC_FIELDS:
        kw[name] = int(fields[name])
    return DeviceGraph(**kw)


def graph_from_arrays(num_vertices: int, row_ptr, col_idx) -> Graph:
    """A host :class:`Graph` from a reference ``Graph``'s CSR arrays."""
    return Graph(int(num_vertices), np.asarray(row_ptr, np.int64),
                 np.asarray(col_idx, np.int32))


def bipartite_from_arrays(num_left: int, num_right: int, l2r_ptr, l2r_idx,
                          r2l_ptr, r2l_idx) -> BipartiteGraph:
    """A host :class:`BipartiteGraph` from a reference ``BipartiteGraph``'s
    two CSR directions."""
    return BipartiteGraph(int(num_left), int(num_right),
                          np.asarray(l2r_ptr, np.int64),
                          np.asarray(l2r_idx, np.int32),
                          np.asarray(r2l_ptr, np.int64),
                          np.asarray(r2l_idx, np.int32))
