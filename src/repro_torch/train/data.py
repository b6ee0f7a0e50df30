"""Deterministic synthetic data pipeline with coloring-scheduled prefetch
(the port of ``repro.train.data``; numpy, bit-identical to the reference).

Determinism contract (fault tolerance): the batch for (seed, step, host) is
a pure function — restarting from a checkpoint at step k replays exactly the
same stream (``skip-to-step`` is free). Tokens follow a Zipf-ish skew so MoE
routing and vocab shards see realistic imbalance.

Shard scheduling: when many input shards contend on sources (same file
server / disk), ``plan_prefetch_waves`` builds the conflict graph and uses
the paper's coloring to emit contention-free prefetch waves.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np

from ..core import Graph, greedy_color


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    family: str = "dense"           # adds frames/image_embeds stubs
    d_model: int = 0
    enc_seq: int = 0
    num_image_tokens: int = 0


def _rng_for(cfg: DataConfig, step: int, host: int = 0):
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, host, 0xDA7A]))


def batch_for_step(cfg: DataConfig, step: int, host: int = 0,
                   hosts: int = 1) -> Dict[str, np.ndarray]:
    """Host-local slice of the global batch for ``step`` (deterministic)."""
    assert cfg.global_batch % hosts == 0
    b = cfg.global_batch // hosts
    rng = _rng_for(cfg, step, host)
    z = rng.zipf(cfg.zipf_a, size=(b, cfg.seq_len + 1))
    toks = (z % (cfg.vocab_size - 1) + 1).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.standard_normal(
            (b, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    return batch


def data_config_for(model_cfg, shape) -> DataConfig:
    return DataConfig(
        vocab_size=model_cfg.vocab_size, seq_len=shape.seq_len,
        global_batch=shape.global_batch, family=model_cfg.family,
        d_model=model_cfg.d_model,
        enc_seq=model_cfg.encdec.enc_seq if model_cfg.encdec else 0,
        num_image_tokens=model_cfg.vlm.num_image_tokens if model_cfg.vlm else 0)


# ------------------------------------------------- coloring-scheduled waves
def plan_prefetch_waves(shard_sources: Sequence[int]) -> List[List[int]]:
    """Group shards into waves such that no wave reads one source twice.

    ``shard_sources[i]`` = source id (file server / disk) of shard i.
    Returns waves (lists of shard indices) — greedy distance-1 coloring of
    the same-source conflict cliques, on the host."""
    src = np.asarray(shard_sources)
    n = src.shape[0]
    edges = []
    for s in np.unique(src):
        members = np.nonzero(src == s)[0]
        if len(members) > 1:
            ii, jj = np.triu_indices(len(members), k=1)
            edges.append(np.stack([members[ii], members[jj]], 1))
    if edges:
        g = Graph.from_edges(n, np.concatenate(edges, 0))
    else:
        g = Graph.from_edges(n, np.zeros((0, 2), np.int64))
    colors = greedy_color(g)
    return [list(np.nonzero(colors == c)[0])
            for c in range(1, int(colors.max()) + 1)]
