"""MiniCPM-2B [dense]: 40L, d_model 2304, 36H MHA (kv=36), d_ff 5760,
vocab 122753, WSD LR schedule.  [arXiv:2404.06395]"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minicpm-2b", family="dense",
        n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36,
        d_ff=5760, vocab=122753,
        tie_embeddings=True,
        schedule="wsd", lr=1e-2, decay_frac=0.1,
    )
