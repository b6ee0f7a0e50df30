"""whisper-medium [audio]: 24L enc + 24L dec, d_model=1024 16H (MHA kv=16)
d_ff=4096 vocab=51865; conv frontend STUB (input_specs feeds precomputed
frame embeddings [B, 1500, 1024]). [arXiv:2212.04356]"""
from ..models.config import ModelConfig, EncDecConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium", family="encdec", num_layers=24, d_model=1024,
        n_heads=16, n_kv_heads=16, head_dim=64, d_ff=4096, vocab_size=51865,
        act="gelu", tie_embeddings=True,
        encdec=EncDecConfig(enc_layers=24, enc_seq=1500))


def get_smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke", family="encdec", num_layers=2, d_model=128,
        n_heads=4, n_kv_heads=4, head_dim=32, d_ff=256, vocab_size=512,
        act="gelu", tie_embeddings=True,
        encdec=EncDecConfig(enc_layers=2, enc_seq=64))
