"""llama-3.2-vision-11b [vlm]: 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256, cross-attn image layers every 5th block; patch-embedding
frontend STUB (input_specs feeds pre-projected image tokens [B, 1601, 4096]).
[hf:meta-llama/Llama-3.2-11B-Vision]"""
from ..models.config import ModelConfig, VLMConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-11b", family="vlm", num_layers=40, d_model=4096,
        n_heads=32, n_kv_heads=8, head_dim=128, d_ff=14336, vocab_size=128256,
        rope_theta=500_000.0,
        vlm=VLMConfig(cross_every=5, num_image_tokens=1601))


def get_smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama-vision-smoke", family="vlm", num_layers=4, d_model=128,
        n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512,
        rope_theta=500_000.0,
        vlm=VLMConfig(cross_every=2, num_image_tokens=17))
