"""The port's training loss and its gradients against the JAX package, on
the CPU, for the ssm, hybrid and moe architectures (the others, and the
tolerances, in tests/test_torch_train_families.py). The moe losses carry
``Model.AUX_WEIGHT`` times the load-balance loss over the layers; the
SSD scan's gradients come from its Function's recompute."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.models import Model  # noqa: E402
from test_torch_train_families import check_loss_and_grads  # noqa: E402


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-7b",
                                  "qwen2-moe-a2.7b", "deepseek-v2-236b"])
def test_loss_and_gradients_match_the_reference(arch):
    check_loss_and_grads(arch)


def test_the_aux_weight_is_the_reference_s():
    from repro.models.api import Model as JaxModel
    assert Model.AUX_WEIGHT == JaxModel.AUX_WEIGHT == 0.01
