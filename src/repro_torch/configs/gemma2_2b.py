"""gemma2-2b [dense]: 26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000,
local(4096)+global alternating, attn softcap 50 / logit softcap 30, tied
embeddings, post-norms. [arXiv:2408.00118]"""
from ..models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b", family="dense", num_layers=26, d_model=2304,
        n_heads=8, n_kv_heads=4, head_dim=256, d_ff=9216, vocab_size=256000,
        layer_pattern="local_global", local_window=4096,
        attn_softcap=50.0, logit_softcap=30.0, post_norms=True,
        tie_embeddings=True, emb_scale=True)


def get_smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-smoke", family="dense", num_layers=4, d_model=128,
        n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512,
        layer_pattern="local_global", local_window=64,
        attn_softcap=50.0, logit_softcap=30.0, post_norms=True,
        tie_embeddings=True, emb_scale=True)
