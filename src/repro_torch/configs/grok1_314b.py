"""grok-1-314b [moe]: 64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072,
8 experts top-2. Experts TP-shard d_ff (8 experts don't divide model=16;
MoEConfig.partition="tensor" — see DESIGN.md §Arch-applicability).
[hf:xai-org/grok-1]"""
from ..models.config import ModelConfig, MoEConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b", family="moe", num_layers=64, d_model=6144,
        n_heads=48, n_kv_heads=8, head_dim=128, d_ff=32768, vocab_size=131072,
        moe=MoEConfig(num_experts=8, top_k=2, d_expert=32768,
                      partition="tensor"))


def get_smoke_config() -> ModelConfig:
    return ModelConfig(
        name="grok1-smoke", family="moe", num_layers=4, d_model=128,
        n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512,
        moe=MoEConfig(num_experts=4, top_k=2, d_expert=256,
                      partition="tensor"))
