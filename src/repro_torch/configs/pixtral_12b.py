# Copy of src/repro/configs/pixtral_12b.py; only this line differs (tests/test_torch_isolation.py checks it).
"""pixtral-12b [vlm] 40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072.

pixtral-ViT frontend is a STUB — input_specs() provides precomputed patch
embeddings [B, 1024, 5120]; backbone is mistral-nemo style (head_dim 128).
[hf:mistralai/Pixtral-12B-2409; unverified]  long_500k: SKIP (full attention).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=131072,
    head_dim=128,
    rope_theta=1_000_000_000.0,
    n_image_tokens=1024,
)


def reduced() -> ArchConfig:
    return CONFIG.replace(
        name="pixtral-12b-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=160, vocab_size=256, head_dim=16,
        n_image_tokens=8, dtype="float32")
