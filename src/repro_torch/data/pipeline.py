# Copy of src/repro/data/pipeline.py; only this line differs (tests/test_torch_isolation.py checks it).
"""Deterministic synthetic token pipeline (checkpointable).

Zipf-distributed token ids (long-tail like natural text) generated per-step
from (seed, step) so any step is reproducible in isolation — restart
resumes exactly by restoring the step counter. Never emits padded vocab
ids (head/vocab padding stays dead weight, api.pad_heads_for_tp).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass
class PipelineState:
    seed: int
    step: int = 0


class TokenPipeline:
    def __init__(self, vocab_size: int, batch: int, seq_len: int,
                 seed: int = 0, zipf_a: float = 1.2):
        self.vocab = vocab_size
        self.batch = batch
        self.seq = seq_len
        self.state = PipelineState(seed=seed)
        self.zipf_a = zipf_a

    def next_batch(self) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.state.seed, self.state.step]))
        z = rng.zipf(self.zipf_a, size=(self.batch, self.seq))
        tokens = np.minimum(z - 1, self.vocab - 1).astype(np.int32)
        self.state.step += 1
        return {"tokens": tokens}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()

    # checkpointing
    def state_dict(self) -> dict:
        return dataclasses.asdict(self.state)

    def load_state_dict(self, d: dict) -> None:
        self.state = PipelineState(**d)
