"""xLSTM-350M [ssm]: 24 blocks, d_model 1024, 4 heads, alternating
mLSTM (matrix-memory, chunkwise-parallel) and sLSTM (scan) blocks,
vocab 50304, no separate FFN on mLSTM blocks.  [arXiv:2405.04517]"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m", family="xlstm",
        n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab=50304,
        slstm_every=2, mlstm_proj=2,
        tie_embeddings=True,
    )
