"""starcoder2-3b [dense]: 30L d_model=3072 24H (GQA kv=2) d_ff=12288
vocab=49152, GQA + RoPE. [arXiv:2402.19173]"""
from ..models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b", family="dense", num_layers=30, d_model=3072,
        n_heads=24, n_kv_heads=2, head_dim=128, d_ff=12288, vocab_size=49152,
        act="gelu", rope_theta=100_000.0)


def get_smoke_config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-smoke", family="dense", num_layers=4, d_model=128,
        n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512,
        act="gelu", rope_theta=100_000.0)
