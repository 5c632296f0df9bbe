"""The port's vlm family (pixtral-12b's backbone) against the JAX package,
on the CPU.

Reduced pixtral-12b (f32, f32 KV cache) with the reference's parameters
carried by ``params_from_jax``: the no-cache forward over precomputed
image embeddings before the token embeddings, and ``prefill`` and
``decode_step`` through ``Model``. R5 included: ``prefill`` always passes
a cache, so both packages drop the image embeddings there (ROADMAP.md
§3). rtol = atol = 1e-4 as in tests/test_torch_model.py.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as jax_get_reduced  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402

from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.models import build_model, params_from_jax  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from test_torch_model import assert_tree_close  # noqa: E402

ARCH = "pixtral-12b"
TOL = dict(rtol=1e-4, atol=1e-4)
BATCH, S = 2, 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _pair():
    jcfg = jax_get_reduced(ARCH).replace(kv_cache_dtype="float32")
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init_params(0)
    tmodel = build_model(get_reduced(ARCH).replace(
        kv_cache_dtype="float32"), device="cpu")
    tparams = params_from_jax(jax.device_get(jparams), device="cpu")
    return jcfg, jmodel, jparams, tmodel, tparams


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (BATCH, S + 1))
    image = rng.standard_normal((BATCH, cfg.n_image_tokens, cfg.d_model)
                                ).astype(np.float32) * 0.02
    return tokens, image


def test_forward_over_image_embeddings_matches_reference():
    jcfg, jmodel, jparams, tmodel, tparams = _pair()
    tokens, image = _inputs(jcfg)
    jl, _, _ = jmodel._lm_forward(jparams, {
        "tokens": jnp.asarray(tokens), "image_embeds": jnp.asarray(image)})
    tl, none = tmodel._lm_forward(tparams, {
        "tokens": torch.from_numpy(tokens),
        "image_embeds": torch.from_numpy(image)})
    assert none is None
    assert tl.shape == (BATCH, jcfg.n_image_tokens + S + 1, jcfg.vocab_size)
    assert_tree_close(tl, jl, **TOL)
    # forward(embeds=) is the same computation
    emb = torch.cat([torch.from_numpy(image),
                     tparams["embed"][torch.from_numpy(tokens)]], dim=1)
    direct, _ = transformer.forward(tparams, tmodel.cfg, embeds=emb)
    torch.testing.assert_close(direct, tl, rtol=0, atol=0)
    # the image embeddings change what the tokens see
    plain, _ = transformer.forward(tparams, tmodel.cfg,
                                   torch.from_numpy(tokens))
    assert float((plain - tl[:, jcfg.n_image_tokens:]).abs().max()) > 1e-3


def test_prefill_and_decode_match_reference_and_drop_images():
    """R5: the reference's prefill passes a cache, so ``image_embeds`` in
    the batch are dropped; the port keeps that."""
    jcfg, jmodel, jparams, tmodel, tparams = _pair()
    tokens, image = _inputs(jcfg, 1)
    jl, jc = jmodel.prefill(jparams, {
        "tokens": jnp.asarray(tokens[:, :S]),
        "image_embeds": jnp.asarray(image),
        "cache": jmodel.init_cache(BATCH, S + 1)})
    tl, tc = tmodel.prefill(tparams, {
        "tokens": torch.from_numpy(tokens[:, :S]),
        "image_embeds": torch.from_numpy(image),
        "cache": tmodel.init_cache(BATCH, S + 1)})
    assert tl.shape == (BATCH, S, jcfg.vocab_size)
    assert_tree_close(tl, jl, **TOL)
    assert_tree_close(tc, jax.device_get(jc), **TOL)
    without, _ = tmodel.prefill(tparams, {
        "tokens": torch.from_numpy(tokens[:, :S]),
        "cache": tmodel.init_cache(BATCH, S + 1)})
    torch.testing.assert_close(without, tl, rtol=0, atol=0)
    jd, jc2 = jmodel.decode_step(jparams, {
        "tokens": jnp.asarray(tokens[:, S:]), "cache": jc})
    td, tc2 = tmodel.decode_step(tparams, {
        "tokens": torch.from_numpy(tokens[:, S:]), "cache": tc})
    assert_tree_close(td, jd, **TOL)
    assert_tree_close(tc2, jax.device_get(jc2), **TOL)


def test_full_width_config_is_the_reference():
    cfg = get_config(ARCH)
    assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.n_heads,
            cfg.n_kv_heads, cfg.resolved_head_dim, cfg.d_ff,
            cfg.vocab_size, cfg.n_image_tokens) == (
        "vlm", 40, 5120, 32, 8, 128, 14336, 131072, 1024)
