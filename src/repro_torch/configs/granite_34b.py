"""Granite-34B-Code [dense]: 88L, d_model 6144, 48H MQA (kv=1),
d_ff 24576, vocab 49152.  [arXiv:2405.04324]"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-34b", family="dense",
        n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1,
        d_ff=24576, vocab=49152,
        mlp="gelu",           # gpt-bigcode-style 2-matrix MLP
        norm="layernorm", norm_eps=1e-5,
        tie_embeddings=True,  # granite code ties embeddings
    )
