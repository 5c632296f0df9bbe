# Copy of src/repro/configs/gemma2_27b.py; only this line differs (tests/test_torch_isolation.py checks it).
"""gemma2-27b [dense] 46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000.

Local(4096-window)+global alternating attention, attn-logit softcap 50,
final-logit softcap 30, GeGLU, pre+post block norms, head_dim=128.
[arXiv:2408.00118; hf-verified]

long_500k: RUN — local layers are sliding-window (sub-quadratic); only the 23
global layers keep a full-length cache (see DESIGN.md §4).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    d_ff=36864,
    vocab_size=256000,
    head_dim=128,
    attn_softcap=50.0,
    logit_softcap=30.0,
    sliding_window=4096,
    local_global_alternating=True,
    post_block_norms=True,
    mlp_act="gelu_tanh",
    embed_scale=True,
    tie_embeddings=True,
    subquadratic=True,   # half the layers are windowed; global layers are O(1)/step at decode
)


def reduced() -> ArchConfig:
    return CONFIG.replace(
        name="gemma2-27b-reduced", n_layers=4, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=160, vocab_size=256, head_dim=16,
        sliding_window=16, dtype="float32")
