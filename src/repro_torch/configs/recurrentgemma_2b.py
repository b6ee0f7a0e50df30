"""recurrentgemma-2b [hybrid]: 26L d_model=2560 10H (GQA kv=1) d_ff=7680,
RG-LRU + local attn in Griffin (rec,rec,attn) pattern, window 2048, lru
width 2560. [arXiv:2402.19427]"""
from ..models.config import ModelConfig, RGLRUConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b", family="hybrid", num_layers=26, d_model=2560,
        n_heads=10, n_kv_heads=1, head_dim=256, d_ff=7680, vocab_size=256000,
        local_window=2048, tie_embeddings=True, emb_scale=True,
        rglru=RGLRUConfig(d_rnn=2560, conv_width=4))


def get_smoke_config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-smoke", family="hybrid", num_layers=5, d_model=128,
        n_heads=4, n_kv_heads=1, head_dim=32, d_ff=256, vocab_size=512,
        local_window=32, tie_embeddings=True, emb_scale=True,
        rglru=RGLRUConfig(d_rnn=128, conv_width=4))
