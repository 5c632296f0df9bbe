"""Staged LM decode payloads (counterpart of src/repro/serving)."""
