"""RecurrentGemma-9B [hybrid]: 38 blocks, d_model 4096, 16H MQA (kv=1)
local attention (window 2048) 1 per 2 RG-LRU recurrent blocks,
d_ff 12288, vocab 256000.  [arXiv:2402.19427]"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b", family="rg_hybrid",
        n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
        d_ff=12288, vocab=256000,
        d_head=256,  # RG uses wide heads (4096/16)
        pattern=("rec", "rec", "attn"),
        lru_width=4096, conv_width=4, local_window=2048,
        mlp="swiglu",  # GeGLU-shaped gated MLP
    )
