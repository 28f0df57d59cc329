"""Llama-3.2-Vision-11B [vlm]: 40 text layers, d_model 4096, 32H GQA
kv=8, d_ff 14336, vocab 128256, gated cross-attention block every 5th
layer over stubbed patch embeddings.  [hf:meta-llama/Llama-3.2-11B-Vision]"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-11b", family="vlm",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab=128256,
        cross_every=5, vision_dim=7680, vision_tokens=1601,
        rope_base=500_000.0,
    )
