"""DeepSeek-V3-671B [moe]: 61L, d_model 7168, 128H MLA, vocab 129280,
MoE: 1 shared + 256 routed experts top-8 (expert d_ff 2048), first 3
layers dense (d_ff 18432), MTP head.  [arXiv:2412.19437]"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b", family="mla_moe",
        n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
        d_ff=18432,            # dense-layer FFN
        vocab=129280,
        n_experts=256, top_k=8, expert_d_ff=2048, n_shared_experts=1,
        first_dense=3,
        mla=True, q_lora=1536, kv_lora=512, d_nope=128, d_rope=64, d_v=128,
        mtp=True, mtp_weight=0.3,
        opt_dtype="bf16",      # moments in bf16 (as the v3 report does)
        rope_base=10_000.0,
    )
