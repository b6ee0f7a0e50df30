"""mamba2-130m [ssm]: 24L d_model=768, attn-free SSD, ssm_state=128,
headdim=64, expand=2. [arXiv:2405.21060]"""
from ..models.config import ModelConfig, SSMConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m", family="ssm", num_layers=24, d_model=768,
        n_heads=1, n_kv_heads=1, d_ff=0, vocab_size=50280, head_dim=64,
        tie_embeddings=True,  # as the released model
        ssm=SSMConfig(d_state=128, headdim=64, expand=2, chunk=256))


def get_smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke", family="ssm", num_layers=4, d_model=128,
        n_heads=1, n_kv_heads=1, d_ff=0, vocab_size=512, head_dim=32,
        ssm=SSMConfig(d_state=16, headdim=32, expand=2, chunk=32))
