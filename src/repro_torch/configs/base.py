# Copy of src/repro/configs/base.py; only this line differs (tests/test_torch_isolation.py checks it).
"""Architecture config schema shared by every assigned architecture.

One ``ArchConfig`` covers all families ("dense", "moe", "ssm", "hybrid",
"encdec", "vlm"); family-specific fields default to None/0 and are only read
by the matching model builder.  Every config module in this package exposes

    CONFIG            -- the exact published configuration
    reduced()         -- a tiny same-family variant for CPU smoke tests
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    # --- attention options -------------------------------------------------
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    logit_softcap: float = 0.0       # final-logit softcap (gemma2: 30)
    attn_softcap: float = 0.0        # attention-logit softcap (gemma2: 50)
    sliding_window: int = 0          # local-attention window (gemma2: 4096)
    local_global_alternating: bool = False   # gemma2 layer pattern
    post_block_norms: bool = False   # gemma2 extra post-norms
    mlp_act: str = "silu"            # silu | gelu | gelu_tanh
    norm_eps: float = 1e-6
    embed_scale: bool = False        # gemma-style sqrt(d) embedding scaling
    tie_embeddings: bool = False
    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0
    n_experts_active: int = 0        # top-k
    moe_d_ff: int = 0                # per-expert hidden
    n_shared_experts: int = 0
    shared_d_ff: int = 0             # total hidden of fused shared experts
    n_dense_layers: int = 0          # leading dense (non-MoE) layers
    router_norm_topk: bool = False   # normalize top-k gate weights
    ep_shards: int = 1               # EP shard width: experts pad to multiple
    # --- MLA (deepseek-v2) ---------------------------------------------------
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # --- SSM (mamba2 / zamba2) ----------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_ngroups: int = 1
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    attn_every: int = 0              # hybrid: shared attn applied every k ssm layers
    # --- enc-dec / vlm frontends (stubs provide embeddings) -----------------
    n_encoder_layers: int = 0
    encoder_frames: int = 0          # whisper stub frame count
    n_image_tokens: int = 0          # pixtral stub patch count
    # --- numerics / serving -------------------------------------------------
    dtype: str = "bfloat16"
    kv_cache_dtype: str = "bfloat16"   # "int8" enables quantized KV cache
    # ``long_500k`` applicability (pure full-attention archs skip it)
    subquadratic: bool = False

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Input-shape cells assigned to every LM arch (seq_len, global_batch, kind)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


SHAPES: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", 4096, 256, "train"),
    ShapeCell("prefill_32k", 32768, 32, "prefill"),
    ShapeCell("decode_32k", 32768, 128, "decode"),
    ShapeCell("long_500k", 524288, 1, "decode"),
)


def shape_by_name(name: str) -> ShapeCell:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)
