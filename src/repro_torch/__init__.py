"""DARIS on PyTorch and CUDA: the port of the JAX package ``repro``.

It imports ``torch`` and nothing of ``jax`` or ``repro``. The scheduler
stack is a copy of the reference's (each copied module names its original
on its first line); the realtime backend, the dense LM, its staging and the
Hopper kernels under ``kernels/`` are the port's own. Entry points run on
the card unless the caller passes ``device="cpu"``.
"""
