"""Parameter initialization with logical-axis annotations (the port of
``repro.models.params``).

A params tree is a tree of ``nn.Module``\\ s. Every node is a
:class:`ParamTree`: its leaves are ``nn.Parameter``\\ s in ``param_dtype``
(float32, as in the reference), its inner nodes are ParamTrees, and a
*stacked* child (the reference's scanned ``blocks``, whose every leaf has a
leading "layers" dim) is an ``nn.ModuleList`` of per-layer ParamTrees.
Beside it the ParamBuilder records the reference's logical-axes tree unchanged
(nested dicts of tuples, ``"layers"`` leading the stacked leaves), which
the sharding slice maps to mesh specs.

**Path rule.** The reference leaf ``a/b/leaf`` is the port parameter
``a.b.leaf``. A reference leaf ``S/rest`` of shape ``(n, *s)`` under a
stacked child ``S`` is the ``n`` port parameters ``S.{g}.rest`` of shape
``s``, ``g = 0 .. n-1`` (:func:`reference_leaves` walks the port tree in
the reference's layout).

Two modes share one code path:
  * concrete — ``ParamBuilder(generator, device)`` samples on ``device``
    from the explicit ``torch.Generator`` (which must live on that device);
  * abstract — ``device="meta"`` records shapes and dtypes only, so the
    314B-param grok config never allocates a byte (``counting``).

Parameters are made with ``requires_grad=False``: the serving path needs no
gradient; a trainer turns them on with ``module.requires_grad_()``.
"""
from __future__ import annotations

import copy
from typing import Iterator, List, Optional, Tuple

import torch
from torch import nn


class ParamTree(nn.Module):
    """One node of a params tree; ``node["name"]`` reads a parameter or a
    child, as the reference's dict does."""

    def __getitem__(self, name: str):
        if name in self._parameters:
            return self._parameters[name]
        if name in self._modules:
            return self._modules[name]
        raise KeyError(name)


class ParamBuilder:
    """Records (parameter, logical axes) pairs into a :class:`ParamTree`."""

    def __init__(self, generator: Optional[torch.Generator], device,
                 param_dtype: torch.dtype = torch.float32,
                 node: Optional[ParamTree] = None):
        self.device = torch.device(device)
        self.abstract = self.device.type == "meta"
        if not self.abstract and generator is None:
            raise ValueError("a concrete ParamBuilder needs a torch.Generator "
                             "(use device='meta' for shapes only)")
        self.generator = generator
        self.dtype = param_dtype
        self.params = ParamTree() if node is None else node
        self.axes: dict = {}

    def _put(self, name, shape, axes, sample):
        assert len(shape) == len(axes), (name, shape, axes)
        if self.abstract:
            t = torch.empty(tuple(shape), dtype=self.dtype, device="meta")
        else:
            t = sample()
        self.params.register_parameter(name, nn.Parameter(t, requires_grad=False))
        self.axes[name] = tuple(axes)
        return self

    def dense(self, name: str, shape, axes, scale: Optional[float] = None):
        std = scale if scale is not None else shape[0] ** -0.5

        def sample():
            return torch.randn(tuple(shape), generator=self.generator,
                               device=self.device, dtype=self.dtype) * std

        return self._put(name, shape, axes, sample)

    def zeros(self, name: str, shape, axes):
        return self._put(name, shape, axes, lambda: torch.zeros(
            tuple(shape), dtype=self.dtype, device=self.device))

    def _sub(self) -> "ParamBuilder":
        return ParamBuilder(self.generator, self.device, self.dtype)

    def child(self, name: str) -> "ParamBuilder":
        sub = self._sub()
        self.params.add_module(name, sub.params)
        self.axes[name] = sub.axes
        return sub

    def stacked_child(self, name: str, n: int, init_one):
        """``init_one(builder)`` fills a per-layer builder, ``n`` times; the
        axes gain a leading "layers" dim (the reference's scan axis)."""
        proto = ParamBuilder(None, "meta", self.dtype)
        init_one(proto)
        layers = nn.ModuleList()
        for _ in range(n):
            b = self._sub()
            init_one(b)
            layers.append(b.params)
        self.params.add_module(name, layers)
        self.axes[name] = map_axes(lambda a: ("layers",) + tuple(a),
                                    proto.axes)
        return self

    def build(self):
        return self.params, self.axes


def map_axes(fn, tree):
    """``fn`` over the leaves of a logical-axes tree."""
    if is_axes_leaf(tree):
        return fn(tree)
    return {k: map_axes(fn, v) for k, v in tree.items()}


def is_axes_leaf(x) -> bool:
    return isinstance(x, tuple) and all(e is None or isinstance(e, str) for e in x)


def reference_leaves(node: nn.Module, prefix: Tuple[str, ...] = ()
                     ) -> Iterator[Tuple[Tuple[str, ...], List[torch.Tensor], bool]]:
    """Every leaf of the reference's params tree, from the port's tree:
    ``(path, parts, stacked)``. An unstacked leaf is ``parts[0]``; a
    stacked one (under an ``nn.ModuleList``) is ``torch.stack(parts)``, its
    reference shape ``(len(parts),) + parts[0].shape``."""
    for name, p in node.named_parameters(recurse=False):
        yield prefix + (name,), [p], False
    for name, child in node.named_children():
        if isinstance(child, nn.ModuleList):
            groups = [list(reference_leaves(c)) for c in child]
            for k, (path, _, _) in enumerate(groups[0] if groups else ()):
                yield (prefix + (name,) + path,
                       [grp[k][1][0] for grp in groups], True)
        else:
            yield from reference_leaves(child, prefix + (name,))


def param_axes(node: nn.Module, axes: dict) -> dict:
    """``{parameter name: logical axes}`` of a params module from its
    logical-axes tree: a stacked leaf's per-layer parameters drop the
    leading ``"layers"`` axis (which no rule shards)."""
    names = {id(p): n for n, p in node.named_parameters()}
    out = {}
    for path, parts, stacked in reference_leaves(node):
        a = axes
        for key in path:
            a = a[key]
        for p in parts:
            out[names[id(p)]] = tuple(a)[1:] if stacked else tuple(a)
    return out


def reference_shape(parts: List[torch.Tensor], stacked: bool) -> Tuple[int, ...]:
    """The reference leaf's shape (see :func:`reference_leaves`)."""
    shape = tuple(parts[0].shape)
    return (len(parts),) + shape if stacked else shape


def cast_params(node: nn.Module, dtype: torch.dtype) -> nn.Module:
    """A twin of a params tree whose float32 leaves are ``leaf.to(dtype)``
    (plain tensors, made inside the autograd graph, so gradients reach the
    float32 masters); other leaves are shared. The twin keeps the tree's
    classes and layout, so the model reads it as it reads ``node``, and a
    recomputing checkpoint (remat) reads the same copies in the backward
    pass."""
    twin = copy.copy(node)
    twin.__dict__["_parameters"] = {
        name: p.to(dtype) if p.dtype == torch.float32 else p
        for name, p in node._parameters.items()}
    twin.__dict__["_modules"] = {name: cast_params(child, dtype)
                                 for name, child in node._modules.items()}
    return twin


def tree_map(fn, tree):
    """``fn`` over the leaves of a tree of nested dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def dtype_of(name: str) -> torch.dtype:
    """The torch dtype a config names (``"bfloat16"``, ``"float32"``)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt
