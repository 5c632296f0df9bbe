# Copy of src/repro/configs/mamba2_27b.py; only this line differs (tests/test_torch_isolation.py checks it).
"""mamba2-2.7b [ssm] 64L d_model=2560 (attn-free) vocab=50280, ssm_state=128.

SSD (state-space duality). [arXiv:2405.21060; unverified]
d_inner = 5120, headdim 64 -> 80 ssm heads (80/16 = 5: shards cleanly).

long_500k: RUN (attention-free; O(1) decode state).
DARIS note: attention-specific KV tricks are N/A; staging/priorities apply
unchanged (DESIGN.md §4).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_ngroups=1,
    subquadratic=True,
    tie_embeddings=True,
)


def reduced() -> ArchConfig:
    return CONFIG.replace(
        name="mamba2-2.7b-reduced", n_layers=3, d_model=64, vocab_size=256,
        ssm_state=16, ssm_headdim=16, ssm_chunk=8, dtype="float32")
