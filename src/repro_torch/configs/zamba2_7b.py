# Copy of src/repro/configs/zamba2_7b.py; only this line differs (tests/test_torch_isolation.py checks it).
"""zamba2-7b [hybrid] 81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000, ssm_state=64.

Mamba2 backbone + ONE shared-weight attention block applied every 6 mamba
layers (13 applications, distinct KV caches, weight-tied). [arXiv:2411.15242;
unverified]  81 counts the mamba blocks; the shared block is weight-tied and
not counted (DESIGN.md §4).

long_500k: RUN (hybrid — SSM state is O(1); the 13 shared-attn caches are the
only full-length state).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    head_dim=112,            # 3584/32
    ssm_state=64,
    ssm_expand=2,
    ssm_headdim=64,          # d_inner 7168 -> 112 ssm heads
    attn_every=6,
    subquadratic=True,
)


def reduced() -> ArchConfig:
    return CONFIG.replace(
        name="zamba2-7b-reduced", n_layers=5, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=160, vocab_size=256, head_dim=16,
        ssm_state=16, ssm_headdim=16, attn_every=2, ssm_chunk=8,
        dtype="float32")
