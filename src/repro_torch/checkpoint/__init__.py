"""Checkpoints of the port, in the JAX package's file formats (``ckpt``)."""
from .ckpt import (load_pytree, load_scheduler_state, save_pytree,
                   save_scheduler_state)  # noqa: F401
