"""Qwen1.5-110B [dense]: 80L, d_model 8192, 64H GQA kv=8, d_ff 49152,
vocab 152064, QKV bias.  [hf:Qwen/Qwen1.5-110B]"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-110b", family="dense",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=49152, vocab=152064, qkv_bias=True,
        rope_base=1_000_000.0,
    )
