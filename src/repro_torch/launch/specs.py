"""Abstract inputs and sharding builders for every (architecture x shape x
mode) cell (the port of ``repro.launch.specs``): meta tensors in place of
the reference's ``ShapeDtypeStruct``\\ s (no allocation), and DTensor
placements in place of its ``NamedSharding``\\ s. Modality frontends are
stubs: whisper gets precomputed frame embeddings, llama-vision
pre-projected image tokens.

A placements tree says how a tree of tensors lies on a mesh; the mesh
itself is passed beside it (:func:`device_put`, ``checkpoint.restore``).
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ..models import cache_spec as model_cache_spec
from ..models.config import ModelConfig, ShapeConfig
from ..models.params import tree_map
from ..parallel.sharding import Rules, mesh_axes, placements, spec_for_array


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """Abstract training/prefill batch for one cell (meta tensors)."""
    b, s = shape.global_batch, shape.seq_len
    out = {
        "tokens": torch.empty((b, s), dtype=torch.int32, device="meta"),
        "labels": torch.empty((b, s), dtype=torch.int32, device="meta"),
    }
    if cfg.family == "encdec":
        out["frames"] = torch.empty((b, cfg.encdec.enc_seq, cfg.d_model),
                                    dtype=torch.bfloat16, device="meta")
    if cfg.family == "vlm":
        out["image_embeds"] = torch.empty(
            (b, cfg.vlm.num_image_tokens, cfg.d_model), dtype=torch.bfloat16,
            device="meta")
    return out


def batch_axes(cfg: ModelConfig) -> Dict[str, tuple]:
    out = {"tokens": ("batch", None), "labels": ("batch", None)}
    if cfg.family == "encdec":
        out["frames"] = ("batch", None, None)
    if cfg.family == "vlm":
        out["image_embeds"] = ("batch", None, None)
    return out


def decode_specs(cfg: ModelConfig, shape: ShapeConfig):
    """(caches abstract tree, caches axes, tokens abstract) for decode
    cells."""
    shapes, axes = model_cache_spec(cfg, shape.global_batch, shape.seq_len)
    tokens = torch.empty((shape.global_batch,), dtype=torch.int32,
                         device="meta")
    return shapes, axes, tokens


def tree_shardings(shape_tree, axes_tree, rules: Rules, mesh):
    """The placements tree of ``shape_tree`` (nested dicts whose leaves have
    a ``shape``: tensors, meta tensors) under ``axes_tree`` (the same
    dicts, logical-axes tuples at the leaves) on ``mesh``."""
    if isinstance(shape_tree, dict):
        return {k: tree_shardings(v, axes_tree[k], rules, mesh)
                for k, v in shape_tree.items()}
    return placements(spec_for_array(tuple(shape_tree.shape), axes_tree,
                                     rules, mesh), mesh)


def scalar_sharding(mesh) -> tuple:
    """A replicated leaf's placements on ``mesh``."""
    from torch.distributed.tensor import Replicate
    return (Replicate(),) * len(mesh_axes(mesh))


def distribute(t: torch.Tensor, mesh, where: tuple):
    """``t`` (the whole tensor, identical on every rank) as a DTensor on
    ``where``: each rank keeps its shard, and nothing crosses the wire."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, mesh, list(where), src_data_rank=None)


@torch.no_grad()
def device_put(params: nn.Module, shardings: Dict[str, tuple], mesh):
    """``jax.tree.map(jax.device_put, params, p_sh)`` for a params module:
    every parameter (named as ``named_parameters`` names it) becomes an
    ``nn.Parameter`` over a DTensor on ``shardings[name]``, in place; the
    whole tensors are freed. Returns ``params``."""
    for name, p in list(params.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = params.get_submodule(owner) if owner else params
        mod.register_parameter(leaf, nn.Parameter(
            distribute(p.detach(), mesh, shardings[name]),
            requires_grad=p.requires_grad))
    return params


def batch_put(batch: Dict[str, torch.Tensor], cfg: ModelConfig,
              rules: Rules, mesh) -> Dict[str, torch.Tensor]:
    """A global batch (the same on every rank) split on ``"batch"``; a
    leaf that is already a DTensor is kept as it is."""
    from torch.distributed.tensor import DTensor
    axes = batch_axes(cfg)
    sh = tree_shardings(batch, {k: axes[k] for k in batch}, rules, mesh)
    return {k: v if isinstance(v, DTensor) else distribute(v, mesh, sh[k])
            for k, v in batch.items()}


def placements_of(tree):
    """The placements tree of a state tree: a DTensor leaf's placements,
    ``None`` for a plain tensor."""
    from torch.distributed.tensor import DTensor
    return tree_map(lambda t: tuple(t.placements)
                    if isinstance(t, DTensor) else None, tree)
