"""LM families of the port, dense and ssm (counterpart of src/repro/models)."""
from .api import Model, build_model, params_from_jax

__all__ = ["Model", "build_model", "params_from_jax"]
