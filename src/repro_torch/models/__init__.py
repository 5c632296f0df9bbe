"""Models of the port: the dense, moe, ssm and hybrid LM families and the
paper's staged CNNs (counterpart of src/repro/models)."""
from .api import Model, build_model, params_from_jax
from .cnn import BUILDERS, StagedCNN, cnn_params_from_jax

__all__ = ["BUILDERS", "Model", "StagedCNN", "build_model",
           "cnn_params_from_jax", "params_from_jax"]
