# Copy of src/repro/configs/qwen2_moe_a27b.py; only this line differs (tests/test_torch_isolation.py checks it).
"""qwen2-moe-a2.7b [moe] 24L d_model=2048 16H (kv=16) d_ff=1408 vocab=151936, MoE 60e top-4.

4 shared + 60 routed experts top-4. [hf:Qwen/Qwen1.5-MoE-A2.7B; hf-verified]
shared_d_ff = 5632 (published shared_expert_intermediate_size).
60 experts pad to 64 for the 16-way EP shard (4 dummy experts masked from
routing — see DESIGN.md §5); config keeps the published 60.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,               # routed-expert hidden (no separate dense layers)
    vocab_size=151936,
    qkv_bias=True,
    n_experts=60,
    n_experts_active=4,
    moe_d_ff=1408,
    n_shared_experts=4,
    shared_d_ff=5632,
    router_norm_topk=True,
    rope_theta=1_000_000.0,
)


def reduced() -> ArchConfig:
    return CONFIG.replace(
        name="qwen2-moe-a2.7b-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=32, vocab_size=256, n_experts=8,
        n_experts_active=2, moe_d_ff=32, shared_d_ff=64, dtype="float32")
