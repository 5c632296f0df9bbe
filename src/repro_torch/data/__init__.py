"""Training data of the port: the reference's deterministic synthetic token
pipeline (``pipeline.py``, a copy; numpy only)."""
