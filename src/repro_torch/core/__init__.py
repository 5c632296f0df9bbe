"""Scheduler core, copied from the JAX package (see each module's first line)."""
