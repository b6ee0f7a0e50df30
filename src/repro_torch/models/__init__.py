"""Model zoo of the port: one composable stack, six families, ten assigned
architectures (the port of ``repro.models``).

Public API (family-dispatched, the reference's names):
    init_params(cfg, generator, device)  -> (module, axes); device="meta"
                                            is abstract (shapes only)
    forward(cfg, params, batch)          -> (logits, aux, caches|None)
    loss_fn(cfg, params, batch)          -> (loss, metrics)
    cache_spec(cfg, batch, max_len)      -> (meta cache tree, axes tree)
    init_cache(cfg, batch, max_len, device) -> zeroed cache tree
    decode_step(cfg, params, caches, tokens) -> (logits, caches')

``params`` is the ``nn.Module`` :func:`init_params` returns (an
:class:`~.transformer.LMStack` or a :class:`~.whisper.EncDecStack`);
``repro_torch.convert.lm_params_from_arrays`` builds one from the
reference's params tree. Caches are written in place (``transformer``).
Entry points run on the card unless ``device="cpu"`` is passed; without
a card they raise.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.graph import DeviceSpec, resolve_device
from .config import (ModelConfig, ShapeConfig, SHAPES, MoEConfig, MLAConfig,
                     SSMConfig, RGLRUConfig, EncDecConfig, VLMConfig)
from . import transformer, whisper, counting


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: DeviceSpec = None):
    """(module, logical axes) with weights drawn from ``generator``, which
    must live on ``device``; ``device="meta"`` needs no generator."""
    dev = resolve_device(device)
    if cfg.family == "encdec":
        return whisper.init_encdec(cfg, generator, dev)
    return transformer.init_lm(cfg, generator, dev)


def loss_fn(cfg: ModelConfig, params, batch):
    if cfg.family == "encdec":
        logits, aux, _ = whisper.forward(cfg, params, batch["tokens"], batch["frames"])
        nll = transformer.chunked_xent(logits, batch["labels"])
        return nll, {"nll": nll, "aux": torch.zeros((), dtype=torch.float32,
                                                    device=logits.device)}
    return transformer.loss_fn(cfg, params, batch)


def forward(cfg: ModelConfig, params, batch, caches=None):
    if cfg.family == "encdec":
        return whisper.forward(cfg, params, batch["tokens"], batch["frames"],
                               caches=caches)
    return transformer.forward(cfg, params, batch["tokens"],
                               image_embeds=batch.get("image_embeds"),
                               caches=caches)


def cache_spec(cfg: ModelConfig, batch: int, max_len: int):
    if cfg.family == "encdec":
        return whisper.cache_spec(cfg, batch, max_len)
    return transformer.cache_spec(cfg, batch, max_len)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: DeviceSpec = None):
    shapes, _ = cache_spec(cfg, batch, max_len)
    return transformer.zeros_like_spec(shapes, resolve_device(device))


def decode_step(cfg: ModelConfig, params, caches, tokens):
    if cfg.family == "encdec":
        return whisper.decode_step(cfg, params, caches, tokens)
    return transformer.decode_step(cfg, params, caches, tokens)


__all__ = [
    "ModelConfig", "ShapeConfig", "SHAPES", "MoEConfig", "MLAConfig",
    "SSMConfig", "RGLRUConfig", "EncDecConfig", "VLMConfig",
    "init_params", "loss_fn", "forward", "cache_spec", "init_cache",
    "decode_step", "counting",
]
