"""Mixtral-8x22B [moe]: 56L, d_model 6144, 48H GQA kv=8, expert d_ff
16384, vocab 32768, 8 experts top-2, sliding-window attention.
[arXiv:2401.04088]"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b", family="moe",
        n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=16384, vocab=32768,
        n_experts=8, top_k=2, expert_d_ff=16384,
        window=4096,  # SWA
        rope_base=1_000_000.0,
    )
