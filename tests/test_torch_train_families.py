"""The port's training loss and its gradients against the JAX package, on
the CPU: dense, gemma2, vlm and encdec architectures here, the ssm,
hybrid and moe ones in tests/test_torch_train_families_ssm_moe.py (split
so that each file runs in well under a minute).

Each reduced config (f32) draws the reference's parameters (``repro``'s
``init_params(0)``, one jitted program) and carries them over with
``params_from_jax``; the batch is tests/test_arch_smoke.py's (2 x 16
seeded tokens, whisper's seeded frames, pixtral's seeded image
embeddings). ``jax.value_and_grad(model.loss)`` against the port's
``Model.loss`` and ``torch.autograd.grad`` over every parameter leaf:

* the loss within 1e-5 relative (both f32; the frameworks sum in other
  orders, about 1e-7 apart);
* each gradient leaf within ``GRAD_TOL`` of its scale: the leaf's largest
  |g|, or 1e-3 of the largest |g| of any leaf where that is more (a leaf
  whose true gradient is 0, such as a key bias under softmax, holds only
  rounding noise in both). Observed: under 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as jax_get_reduced  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402

from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.models import build_model, params_from_jax  # noqa: E402
from repro_torch.training.train_step import (make_loss_fn,  # noqa: E402
                                             value_and_grad)

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
NOISE_FLOOR = 1e-3        # of the largest |g| of any leaf


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def batch_arrays(cfg, b=2, s=16, seed=0) -> dict:
    """tests/test_arch_smoke.py's ``_batch`` as numpy arrays."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s))}
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(
            size=(b, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.normal(
            size=(b, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return batch


def reference_pair(arch: str):
    """(reference model, its parameters, the port's model, the same
    parameters as tensors)."""
    jmodel = jax_build_model(jax_get_reduced(arch))
    jparams = jax.jit(lambda: jmodel.init_params(0))()
    tmodel = build_model(get_reduced(arch), device="cpu")
    return (jmodel, jparams, tmodel,
            params_from_jax(jax.device_get(jparams), device="cpu"))


def leaf_paths(tree, prefix=""):
    """{path: leaf} of a tree of dicts and lists."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        if isinstance(tree, torch.Tensor):
            return {prefix: tree.detach().float().numpy()}
        return {prefix: np.asarray(tree, np.float32)}
    out = {}
    for k, v in items:
        out.update(leaf_paths(v, f"{prefix}/{k}"))
    return out


def assert_grads_close(ours, ref, tol=GRAD_TOL):
    """Every leaf of ``ours`` within ``tol`` of its scale of ``ref``'s."""
    a, b = leaf_paths(ours), leaf_paths(ref)
    assert set(a) == set(b)
    top = max(float(np.abs(v).max()) for v in b.values())
    for path, want in b.items():
        scale = max(float(np.abs(want).max()), NOISE_FLOOR * top)
        err = float(np.abs(a[path] - want).max())
        assert err <= tol * scale, (path, err, scale)


def check_loss_and_grads(arch: str) -> None:
    jmodel, jparams, tmodel, tparams = reference_pair(arch)
    arrays = batch_arrays(jmodel.cfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(jmodel.loss))(
        jparams, {k: jnp.asarray(v) for k, v in arrays.items()})
    loss, grads = value_and_grad(
        make_loss_fn(tmodel, remat="none"), tparams,
        {k: torch.from_numpy(v) for k, v in arrays.items()})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    assert_grads_close(grads, jax.device_get(jgrads))


@pytest.mark.parametrize("arch", ["qwen1.5-32b", "gemma2-27b", "stablelm-12b",
                                  "smollm-135m", "pixtral-12b",
                                  "whisper-tiny"])
def test_loss_and_gradients_match_the_reference(arch):
    check_loss_and_grads(arch)


def test_vlm_loss_reads_only_the_token_rows_and_encdec_is_teacher_forced():
    """pixtral's loss leaves out the image rows' logits (changing the last
    image row's logits' target can not move it); whisper's decoder sees
    ``tokens[:, :-1]`` and is scored on ``tokens[:, 1:]``."""
    tmodel = build_model(get_reduced("pixtral-12b"), device="cpu")
    params = tmodel.init_params(0)
    arrays = batch_arrays(tmodel.cfg)
    batch = {k: torch.from_numpy(v) for k, v in arrays.items()}
    with torch.no_grad():
        loss = tmodel.loss(params, batch)
        logits, _ = tmodel._lm_forward(params, batch)
    n_img = arrays["image_embeds"].shape[1]
    lf = logits[:, n_img:-1].float()
    want = (torch.logsumexp(lf, -1) - lf.gather(
        -1, batch["tokens"][:, 1:, None].long())[..., 0]).mean()
    torch.testing.assert_close(loss, want, rtol=1e-6, atol=1e-6)
    wmodel = build_model(get_reduced("whisper-tiny"), device="cpu")
    wp = wmodel.init_params(0)
    wa = batch_arrays(wmodel.cfg)
    wb = {k: torch.from_numpy(v) for k, v in wa.items()}
    with torch.no_grad():
        wloss = wmodel.loss(wp, wb)
        enc = wmodel.encode(wp, wb["frames"])
        from repro_torch.models import encdec
        wl, _ = encdec.decode(wp, wb["tokens"][:, :-1], enc, wmodel.cfg)
    wl = wl.float()
    want = (torch.logsumexp(wl, -1) - wl.gather(
        -1, wb["tokens"][:, 1:, None].long())[..., 0]).mean()
    torch.testing.assert_close(wloss, want, rtol=1e-6, atol=1e-6)
