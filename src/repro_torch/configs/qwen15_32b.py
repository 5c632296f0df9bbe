# Copy of src/repro/configs/qwen15_32b.py; only this line differs (tests/test_torch_isolation.py checks it).
"""qwen1.5-32b [dense] 64L d_model=5120 40H (GQA kv=40) d_ff=27392 vocab=152064, QKV bias.

[hf:Qwen/Qwen1.5-0.5B family; hf-verified]
40 heads is not divisible by the 16-way ``model`` mesh axis; the launcher pads
attention heads to 48 for tensor parallelism (see DESIGN.md §5) — config keeps
the published head count, padding is applied at sharding time.
decode_32k KV cache is 5.5 TB in bf16 and does not fit a 256x16GB pod; the
serving path uses an int8 KV cache for this arch (beyond-paper optimization).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27392,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    kv_cache_dtype="int8",
)


def reduced() -> ArchConfig:
    return CONFIG.replace(
        name="qwen1.5-32b-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=160, vocab_size=256, dtype="float32",
        kv_cache_dtype="bfloat16")
