# Copy of src/repro/configs/whisper_tiny.py; only this line differs (tests/test_torch_isolation.py checks it).
"""whisper-tiny [audio] 4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865.

Enc-dec; conv/audio frontend is a STUB — input_specs() provides precomputed
frame embeddings [B, 1500, 384]. [arXiv:2212.04356; unverified]
6 heads can't shard 16-way; attention weights replicated (tiny model).
decode_32k exercised structurally (beyond the published 448 positions) —
shape/compile exercise, noted in DESIGN.md. long_500k: SKIP (full attention).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="encdec",
    n_layers=4,              # decoder layers
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    n_encoder_layers=4,
    encoder_frames=1500,
    mlp_act="gelu",
    rope_theta=0.0,          # whisper uses learned/sinusoidal positions
)


def reduced() -> ArchConfig:
    return CONFIG.replace(
        name="whisper-tiny-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=160, vocab_size=256, n_encoder_layers=2,
        encoder_frames=16, dtype="float32")
