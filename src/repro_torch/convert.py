"""Carry state across from the reference package.

The coloring system has no weights: its state is the graph. These functions
rebuild the port's containers from the numpy arrays of the reference's
(``repro.core.graph``) containers, so both packages can color the identical
device layout. The LM lane's state is its weights and its optimizer state:
:func:`lm_params_from_arrays` builds the port's params module from the
reference's ``init_params`` tree, :func:`opt_state_from_arrays` the port's
AdamW state from the reference's, and the ``*_to_arrays`` functions go
back, so a ``{"params", "opt"}`` checkpoint of either trainer restores in
the other. They take plain arrays, never reference objects: the port does
not import the reference. A bf16 leaf, which numpy holds only through
``ml_dtypes``, may come in as such an array or as a ``torch.bfloat16``
tensor (what ``train.checkpoint.load`` gives), and goes out as the latter.
The ``*_to_arrays`` functions take DTensor leaves too (a sharded run's
state), gathering each leaf's global value: every rank of the mesh calls
them.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .core.graph import (BipartiteGraph, DeviceGraph, DeviceSpec, Graph,
                         resolve_device)
from .models.params import reference_leaves, reference_shape
from .parallel.sharding import whole

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


def _leaf_count(tree) -> int:
    if isinstance(tree, Mapping):
        return sum(_leaf_count(v) for v in tree.values())
    return 1


def lm_params_from_arrays(cfg, tree: Mapping, device: DeviceSpec = None):
    """The port's params module for ``cfg`` (an ``LMStack`` or
    ``EncDecStack``, on ``device``; ``None`` = the card) holding the
    weights of the reference's ``init_params`` tree: nested dicts whose
    leaves are arrays (anything ``np.asarray`` takes). A leaf of shape
    ``(n, *s)`` under a stacked child fills the ``n`` per-layer parameters
    (``repro_torch.models.params`` has the path rule). Raises if a leaf is
    missing, extra or of another shape."""
    from .models import init_params
    dev = resolve_device(device)
    module, _ = init_params(cfg, device="meta")
    module = module.to_empty(device=dev)
    n = 0
    for path, parts, stacked in reference_leaves(module):
        node = tree
        for key in path:
            if not isinstance(node, Mapping) or key not in node:
                raise KeyError(f"reference params have no leaf "
                               f"{'/'.join(path)}")
            node = node[key]
        arr = np.asarray(node)
        want = reference_shape(parts, stacked)
        if arr.shape != want:
            raise ValueError(f"{'/'.join(path)}: shape {arr.shape}, the "
                             f"config needs {want}")
        for part, a in zip(parts, arr if stacked else [arr]):
            part.copy_(torch.from_numpy(np.array(a, dtype=np.float32)))
        n += 1
    if n != _leaf_count(tree):
        raise ValueError(f"reference params hold {_leaf_count(tree)} leaves, "
                         f"the config {n}")
    return module


def _tensor(a) -> torch.Tensor:
    """A CPU tensor of a leaf: a tensor, an ``ml_dtypes`` bfloat16 array,
    or anything ``np.asarray`` takes."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _array(t: torch.Tensor):
    """A host leaf: numpy, except bf16, which stays a CPU tensor."""
    t = whole(t.detach()).cpu()
    return t if t.dtype == torch.bfloat16 else t.numpy()


def _names(module) -> dict:
    return {id(p): n for n, p in module.named_parameters()}


def opt_state_from_arrays(module, tree: Mapping) -> dict:
    """The port's AdamW state (``repro_torch.train.optimizer``) for the
    params ``module``, on its parameters' devices, from the reference's
    ``{"m", "v", "step"}``: ``m`` and ``v`` are trees shaped like the
    reference's params (stacked leaves under a stacked child, in the
    moments' dtype, which is kept). Raises if a leaf is missing or of
    another shape."""
    names = _names(module)
    out = {"m": {}, "v": {}}
    for key in ("m", "v"):
        n = 0
        for path, parts, stacked in reference_leaves(module):
            node = tree[key]
            for k in path:
                if not isinstance(node, Mapping) or k not in node:
                    raise KeyError(f"reference opt state has no leaf "
                                   f"{key}/{'/'.join(path)}")
                node = node[k]
            t = _tensor(node)
            want = reference_shape(parts, stacked)
            if tuple(t.shape) != want:
                raise ValueError(f"{key}/{'/'.join(path)}: shape "
                                 f"{tuple(t.shape)}, the config needs {want}")
            for part, a in zip(parts, t if stacked else [t]):
                out[key][names[id(part)]] = a.to(part.device, copy=True)
            n += 1
        if n != _leaf_count(tree[key]):
            raise ValueError(f"reference opt state {key} holds "
                             f"{_leaf_count(tree[key])} leaves, the config {n}")
    dev = next(module.parameters()).device
    out["step"] = _tensor(tree["step"]).to(dev, torch.int32).reshape(())
    return out


def opt_state_to_arrays(module, state: Mapping) -> dict:
    """The inverse of :func:`opt_state_from_arrays`: the reference's
    ``{"m", "v", "step"}`` (stacked children on a leading layers dim;
    float32 moments as numpy arrays, bf16 ones as CPU ``torch.bfloat16``
    tensors, ``step`` an int32 numpy scalar array)."""
    names = _names(module)
    out: dict = {}
    for key in ("m", "v"):
        tree: dict = {}
        for path, parts, stacked in reference_leaves(module):
            ts = [whole(state[key][names[id(p)]]) for p in parts]
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = _array(torch.stack(ts) if stacked else ts[0])
        out[key] = tree
    out["step"] = np.asarray(int(state["step"]), np.int32)
    return out


def lm_params_to_arrays(module) -> dict:
    """The inverse of :func:`lm_params_from_arrays`: the reference's params
    tree (nested dicts of float32 numpy arrays, stacked children on a
    leading layers dim) from the port's module."""
    tree: dict = {}
    for path, parts, stacked in reference_leaves(module):
        arrs = [whole(p.detach()).to("cpu", torch.float32).numpy()
                for p in parts]
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.stack(arrs) if stacked else arrs[0]
    return tree
