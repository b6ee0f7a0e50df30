"""Unified model configuration for all assigned architectures (a copy of
the reference's ``repro.models.config``; the port keeps its own).

One dataclass drives the composable stack: family switches select the block
types, optional sub-configs (moe/mla/ssm/rglru/encdec/vlm) activate features.
Every field maps to a line of the assignment table; reduced ("smoke") configs
reuse the same switches with small dims.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                 # expert FFN hidden size
    num_shared: int = 0           # always-on shared experts (deepseek)
    d_shared: int = 0             # shared-expert hidden size
    first_dense_layers: int = 0   # leading dense layers (deepseek layer 0)
    first_dense_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # sharding: "expert" (EP: experts over model axis) or "tensor" (TP on
    # d_expert — used when num_experts doesn't divide the model axis, grok)
    partition: str = "expert"


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    headdim: int = 64
    expand: int = 2
    chunk: int = 256
    conv_width: int = 4
    n_groups: int = 1


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    d_rnn: int = 0                # lru width (0 -> d_model)
    conv_width: int = 4
    block_pattern: Tuple[str, ...] = ("rec", "rec", "attn")
    tail_pattern: Tuple[str, ...] = ("rec", "rec")  # leftover layers


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    enc_layers: int = 24
    enc_seq: int = 1500           # whisper mel-frame count (conv stub output)
    enc_pos: str = "sinusoid"


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    cross_every: int = 5          # one cross-attn block per 5 layers
    num_image_tokens: int = 1601  # ViT-H/14 @ 448px + cls, pre-projected stub


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    act: str = "swiglu"           # swiglu | gelu
    rope_theta: float = 10_000.0
    qk_norm: bool = False         # qwen3
    attn_softcap: float = 0.0     # gemma2: 50.0
    logit_softcap: float = 0.0    # gemma2: 30.0
    post_norms: bool = False      # gemma2 post-attn/post-ffn norms
    local_window: int = 0         # window for "local" layers
    layer_pattern: str = "global"  # global | local_global | griffin
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    emb_scale: bool = False       # gemma-style sqrt(d) embedding scaling

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    encdec: Optional[EncDecConfig] = None
    vlm: Optional[VLMConfig] = None

    # numerics / training
    dtype: str = "bfloat16"       # activation/compute dtype
    param_dtype: str = "float32"
    remat: bool = True
    scan_layers: bool = True

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def param_count(self) -> int:
        """Total parameters (used for 6·N·D model-FLOPs accounting)."""
        from . import counting
        return counting.param_count(self)

    def active_param_count(self) -> int:
        from . import counting
        return counting.active_param_count(self)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str                     # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
