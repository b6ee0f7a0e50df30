"""qwen3-4b [dense]: 36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936,
qk_norm. [hf:Qwen/Qwen3-8B family]"""
from ..models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-4b", family="dense", num_layers=36, d_model=2560,
        n_heads=32, n_kv_heads=8, head_dim=128, d_ff=9728, vocab_size=151936,
        qk_norm=True, rope_theta=1_000_000.0)


def get_smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-smoke", family="dense", num_layers=4, d_model=128,
        n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512,
        qk_norm=True, rope_theta=1_000_000.0)
