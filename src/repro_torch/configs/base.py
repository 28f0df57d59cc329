"""Config system: architecture + input-shape presets.

Every assigned architecture is a ``ModelConfig``; ``reduced()`` produces
the same-family tiny config the smoke tests instantiate.  Input shapes
are the four assigned presets; ``supported_shapes(cfg)`` encodes which
cells are well-defined (long_500k needs a sub-quadratic decode path).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass
class ModelConfig:
    name: str
    family: str  # dense | moe | mla_moe | rg_hybrid | xlstm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    mlp: str = "swiglu"
    norm: str = "rms"
    norm_eps: float = 1e-6
    rope_base: float = 10000.0
    window: Optional[int] = None  # sliding-window size on self-attn
    tie_embeddings: bool = False
    param_dtype: str = "f32"
    compute_dtype: str = "bf16"
    opt_dtype: str = "f32"
    # -- MoE ------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    n_shared_experts: int = 0
    first_dense: int = 0            # leading dense layers before MoE stack
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # -- MLA (deepseek-v3) ------------------------------------------------
    mla: bool = False
    q_lora: int = 0
    kv_lora: int = 0
    d_nope: int = 0
    d_rope: int = 0
    d_v: int = 0
    mtp: bool = False
    mtp_weight: float = 0.3
    # -- recurrent hybrid (recurrentgemma) ---------------------------------
    pattern: Tuple[str, ...] = ()   # e.g. ("rec", "rec", "attn")
    lru_width: int = 0
    conv_width: int = 4
    local_window: int = 2048
    # -- xlstm -----------------------------------------------------------
    slstm_every: int = 2            # 1 sLSTM block per N blocks
    mlstm_proj: int = 2             # mLSTM up-projection factor
    # -- encoder-decoder (whisper) ----------------------------------------
    n_enc_layers: int = 0
    enc_seq: int = 1500             # stubbed frame-embedding length
    learned_pos: bool = False
    # -- vlm ---------------------------------------------------------------
    cross_every: int = 0            # cross-attn block every N self layers
    vision_dim: int = 0
    vision_tokens: int = 0
    # -- optimizer ------------------------------------------------------------
    lr: float = 3e-4
    schedule: str = "cosine"        # cosine | wsd | constant
    warmup: int = 100
    total_steps: int = 10_000
    decay_frac: float = 0.1         # WSD: final decay fraction of steps
    weight_decay: float = 0.1
    grad_clip: float = 1.0

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def sub_quadratic(self) -> bool:
        """Can decode with O(1)-per-token state (ring/recurrent caches)?"""
        return (self.family in ("rg_hybrid", "xlstm")
                or self.window is not None)

    def reduced(self, **over) -> "ModelConfig":
        """Same-family tiny config for CPU smoke tests."""
        r = dataclasses.replace(
            self,
            name=f"{self.name}-smoke",
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads > 1 else 1,
            d_head=16,
            d_ff=128 if self.d_ff else 0,
            vocab=257,
            q_lora=32 if self.q_lora else 0,
            kv_lora=16 if self.kv_lora else 0,
            d_nope=16 if self.d_nope else 0,
            d_rope=8 if self.d_rope else 0,
            d_v=16 if self.d_v else 0,
            expert_d_ff=32 if self.expert_d_ff else 0,
            n_experts=4 if self.n_experts else 0,
            top_k=min(self.top_k, 2),
            n_shared_experts=min(self.n_shared_experts, 1),
            lru_width=64 if self.lru_width else 0,
            local_window=8 if self.pattern else 2048,
            window=8 if self.window is not None else None,
            vision_dim=48 if self.vision_dim else 0,
            vision_tokens=10 if self.vision_tokens else 0,
            warmup=2,
            total_steps=50,
        )
        if self.family == "rg_hybrid":
            r = dataclasses.replace(r, n_layers=len(self.pattern) + 2)
        elif self.family == "mla_moe":
            r = dataclasses.replace(r, n_layers=3, first_dense=1)
        elif self.family == "vlm":
            r = dataclasses.replace(r, n_layers=2 * self.cross_every)
        elif self.family == "encdec":
            r = dataclasses.replace(r, n_layers=2, n_enc_layers=2, enc_seq=12)
        elif self.family == "xlstm":
            r = dataclasses.replace(r, n_layers=2 * self.slstm_every)
        elif self.family == "moe":
            r = dataclasses.replace(r, n_layers=2)
        else:
            r = dataclasses.replace(r, n_layers=2)
        return dataclasses.replace(r, **over)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str        # train | prefill | decode | long_decode | serve | serve_paged
    seq_len: int
    global_batch: int
    # serve_paged only: KV pages of this many token rows replace the
    # fixed per-slot cache row (None for every other kind)
    page_size: Optional[int] = None


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "long_decode", 524_288, 1),
}


def supported_shapes(cfg: ModelConfig):
    """The well-defined (arch x shape) cells.  long_500k requires a
    sub-quadratic decode path (ring or recurrent state) — full-attention
    archs skip it (see DESIGN.md sec. 4)."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        out.append("long_500k")
    return [SHAPES[s] for s in out]
