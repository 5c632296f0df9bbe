"""Staged payloads (LM decode, the paper's CNNs) and the paper's task sets
(counterpart of src/repro/serving)."""
