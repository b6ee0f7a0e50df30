"""deepseek-v2-lite-16b [moe+mla]: 27L d_model=2048 16H d_ff(expert)=1408
vocab=102400, MLA kv_lora=512 (rope 64 / nope 128 / v 128), MoE 64 routed
top-6 + 2 shared, first layer dense (d_ff 10944). Assigned line says both
"64e" and "160 routed"; real V2-Lite has 64 routed — we implement 64 and
note the discrepancy in DESIGN.md. [arXiv:2405.04434]"""
from ..models.config import ModelConfig, MoEConfig, MLAConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b", family="moe", num_layers=27, d_model=2048,
        n_heads=16, n_kv_heads=16, d_ff=1408, vocab_size=102400,
        moe=MoEConfig(num_experts=64, top_k=6, d_expert=1408, num_shared=2,
                      d_shared=1408, first_dense_layers=1,
                      first_dense_d_ff=10944, partition="expert"),
        mla=MLAConfig(kv_lora_rank=512, rope_head_dim=64, nope_head_dim=128,
                      v_head_dim=128))


def get_smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-smoke", family="moe", num_layers=3, d_model=128,
        n_heads=4, n_kv_heads=4, d_ff=64, vocab_size=512,
        moe=MoEConfig(num_experts=8, top_k=2, d_expert=64, num_shared=1,
                      d_shared=64, first_dense_layers=1, first_dense_d_ff=256,
                      partition="expert"),
        mla=MLAConfig(kv_lora_rank=32, rope_head_dim=16, nope_head_dim=32,
                      v_head_dim=32))
