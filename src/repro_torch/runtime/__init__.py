"""Execution substrates: the copied simulator and engine loop, and the CUDA realtime backend."""
