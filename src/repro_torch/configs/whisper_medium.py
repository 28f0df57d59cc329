"""Whisper-medium [audio]: 24+24L enc-dec, d_model 1024, 16H MHA,
d_ff 4096, vocab 51865.  Conv frontend is a stub: input_specs() provides
precomputed frame embeddings (B, 1500, d).  [arXiv:2212.04356]"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium", family="encdec",
        n_layers=24, n_enc_layers=24, d_model=1024, n_heads=16,
        n_kv_heads=16, d_ff=4096, vocab=51865,
        mlp="gelu", norm="layernorm", norm_eps=1e-5,
        learned_pos=True, enc_seq=1500,
        tie_embeddings=True,
    )
