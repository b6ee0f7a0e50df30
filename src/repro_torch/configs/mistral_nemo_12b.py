"""mistral-nemo-12b [dense]: 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072, 128k ctx. [hf:mistralai/Mistral-Nemo-Base-2407]"""
from ..models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="mistral-nemo-12b", family="dense", num_layers=40, d_model=5120,
        n_heads=32, n_kv_heads=8, head_dim=128, d_ff=14336, vocab_size=131072,
        rope_theta=1_000_000.0)


def get_smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mistral-nemo-smoke", family="dense", num_layers=4, d_model=128,
        n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512,
        rope_theta=1_000_000.0)
