# Copy of src/repro/configs/deepseek_v2_236b.py; only this line differs (tests/test_torch_isolation.py checks it).
"""deepseek-v2-236b [moe] 60L d_model=5120 128H d_ff=1536 vocab=102400, MoE 160e top-6.

MLA kv_lora=512, 2 shared + 160 routed experts top-6, first layer dense.
[arXiv:2405.04434; hf-verified]
d_ff=1536 is the routed-expert hidden; shared experts fused hidden = 2*1536.
Dense layers use d_ff = 12288 (published intermediate_size).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,          # MLA: latent shared; head count for q
    d_ff=12288,              # dense-layer intermediate
    vocab_size=102400,
    n_experts=160,
    n_experts_active=6,
    moe_d_ff=1536,
    n_shared_experts=2,
    shared_d_ff=3072,        # 2 x 1536 fused
    n_dense_layers=1,
    router_norm_topk=True,
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    rope_theta=10000.0,
)


def reduced() -> ArchConfig:
    return CONFIG.replace(
        name="deepseek-v2-236b-reduced", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=160, vocab_size=256, n_experts=8,
        n_experts_active=2, moe_d_ff=32, shared_d_ff=64, n_dense_layers=1,
        q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
        qk_rope_head_dim=8, v_head_dim=16, dtype="float32")
