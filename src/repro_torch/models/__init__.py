"""Models of the port: every LM family of the reference (dense, vlm, moe
with MLA, ssm, hybrid), whisper's encoder-decoder and the paper's staged
CNNs (counterpart of src/repro/models)."""
from .api import Model, build_model, params_from_jax
from .cnn import BUILDERS, StagedCNN, cnn_params_from_jax

__all__ = ["BUILDERS", "Model", "StagedCNN", "build_model",
           "cnn_params_from_jax", "params_from_jax"]
