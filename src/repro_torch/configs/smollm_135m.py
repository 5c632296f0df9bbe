# Copy of src/repro/configs/smollm_135m.py; only this line differs (tests/test_torch_isolation.py checks it).
"""smollm-135m [dense] 30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152.

llama-arch small. [hf:HuggingFaceTB/SmolLM-135M; hf-verified]
9 heads can't shard 16-way; attention weights are replicated across the
``model`` axis (tiny model — see DESIGN.md §5). MLP stays TP (1536/16=96).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    d_ff=1536,
    vocab_size=49152,
    tie_embeddings=True,
)


def reduced() -> ArchConfig:
    return CONFIG.replace(
        name="smollm-135m-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=160, vocab_size=256, dtype="float32")
