# Copy of src/repro/configs/stablelm_12b.py; only this line differs (tests/test_torch_isolation.py checks it).
"""stablelm-12b [dense] 40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352.

[hf:stabilityai/stablelm-2-1_6b family; hf-verified]  head_dim = 5120/32 = 160.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=13824,
    vocab_size=100352,
    qkv_bias=False,
)


def reduced() -> ArchConfig:
    return CONFIG.replace(
        name="stablelm-12b-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=160, vocab_size=256, dtype="float32")
