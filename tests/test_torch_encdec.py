"""The port's encoder-decoder (whisper-tiny's backbone) against the JAX
package, on the CPU.

Reduced whisper-tiny (f32, f32 KV cache) with the reference's parameters
carried by ``params_from_jax``, whose lists of layers it keeps: the
encoder's states (bidirectional layers over sinusoidal positions), the
prefill's logits and self-attention caches (cross-attention to the
encoder states), and two decode steps. rtol = atol = 1e-4 as in
tests/test_torch_model.py. The layer primitives whisper adds (LayerNorm,
the position tables) within 1e-6, the biased GELU MLP within 1e-5.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as jax_get_reduced  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import encdec as jax_encdec  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402

from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.models import build_model, encdec, layers  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402
from test_torch_model import _np, assert_tree_close  # noqa: E402

ARCH = "whisper-tiny"
TOL = dict(rtol=1e-4, atol=1e-4)
PRIM_TOL = dict(rtol=1e-6, atol=1e-6)
BATCH, S = 2, 5


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


def _frames(cfg, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (BATCH, cfg.encoder_frames, cfg.d_model)).astype(np.float32)


def test_parameter_tree_through_params_from_jax():
    """Lists of layers stay lists; the tree is the port's own init's."""
    _, _, jparams, tmodel, tparams = _pair()
    assert isinstance(tparams["enc_layers"], list)
    assert isinstance(tparams["dec_layers"], list)
    assert_tree_close(tparams["dec_layers"][1],
                      jax.device_get(jparams["dec_layers"][1]), rtol=0,
                      atol=0)

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, list):
            return [shapes(v) for v in t]
        return tuple(t.shape)
    assert shapes(tmodel.init_params(0)) == shapes(jax.device_get(jparams))
    assert set(tparams["dec_layers"][0]["cross_attn"]) == {
        "wq", "wk", "wv", "wo", "bq", "bk", "bv", "bo"}


def test_primitives_match_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 7, 64)).astype(np.float32)
    w, b = (rng.standard_normal(64).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(
        _np(layers.layer_norm(*map(torch.from_numpy, (x, w, b)))),
        np.asarray(jax_layers.layer_norm(*map(jnp.asarray, (x, w, b)))),
        **PRIM_TOL)
    np.testing.assert_allclose(
        _np(layers.softcap(torch.from_numpy(x * 40), 30.0)),
        np.asarray(jax_layers.softcap(jnp.asarray(x * 40), 30.0)),
        **PRIM_TOL)
    p = {"w_in": rng.standard_normal((64, 96)).astype(np.float32) / 8,
         "b_in": rng.standard_normal(96).astype(np.float32),
         "w_out": rng.standard_normal((96, 64)).astype(np.float32) / 10,
         "b_out": rng.standard_normal(64).astype(np.float32)}
    np.testing.assert_allclose(
        _np(layers.mlp(params_from_jax(p, device="cpu"),
                       torch.from_numpy(x), "gelu")),
        np.asarray(jax_layers.mlp(jax.tree.map(jnp.asarray, p),
                                  jnp.asarray(x), "gelu")), rtol=1e-5,
        atol=1e-5)
    np.testing.assert_allclose(
        _np(layers.sinusoidal_positions(50, 64)),
        np.asarray(jax_layers.sinusoidal_positions(50, 64)), rtol=0, atol=0)
    pos = np.arange(3, 40, dtype=np.int32)
    np.testing.assert_allclose(
        _np(encdec._pos_embed(torch.from_numpy(pos), 64)),
        np.asarray(jax_encdec._pos_embed(jnp.asarray(pos), 64)), **TOL)


def test_encode_prefill_and_decode_match_reference():
    jcfg, jmodel, jparams, tmodel, tparams = _pair()
    frames = _frames(jcfg)
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab_size,
                                               (BATCH, S + 2))
    jenc = jax_encdec.encode(jparams, jnp.asarray(frames), jcfg)
    tenc = tmodel.encode(tparams, torch.from_numpy(frames))
    assert_tree_close(tenc, jenc, **TOL)
    jl, jc = jmodel.prefill(jparams, {
        "frames": jnp.asarray(frames), "tokens": jnp.asarray(tokens[:, :S]),
        "cache": jmodel.init_cache(BATCH, S + 2)})
    tl, tc = tmodel.prefill(tparams, {
        "frames": torch.from_numpy(frames),
        "tokens": torch.from_numpy(tokens[:, :S]),
        "cache": tmodel.init_cache(BATCH, S + 2)})
    assert tl.shape == (BATCH, S, jcfg.vocab_size)
    assert isinstance(tc["self"], list) and len(tc["self"]) == jcfg.n_layers
    assert_tree_close(tl, jl, **TOL)
    for ours, ref in zip(tc["self"], jax.device_get(jc)["self"]):
        assert_tree_close(ours, ref, **TOL)
    for i in (S, S + 1):
        jl, jc = jmodel.decode_step(jparams, {
            "tokens": jnp.asarray(tokens[:, i:i + 1]), "enc_out": jenc,
            "cache": jc})
        tl, tc = tmodel.decode_step(tparams, {
            "tokens": torch.from_numpy(tokens[:, i:i + 1]), "enc_out": tenc,
            "cache": tc})
        assert_tree_close(tl, jl, **TOL)
        for ours, ref in zip(tc["self"], jax.device_get(jc)["self"]):
            assert_tree_close(ours, ref, **TOL)
    assert int(tc["self"][0]["length"]) == S + 2


def test_cross_attention_sees_every_frame():
    """The decoder's cross-attention is not causal: a change to the last
    frame moves the first token's logits."""
    _, _, _, tmodel, tparams = _pair()
    frames = torch.from_numpy(_frames(tmodel.cfg, 3))
    tok = torch.zeros((BATCH, 1), dtype=torch.int64)
    a, _ = encdec.decode(tparams, tok, tmodel.encode(tparams, frames),
                         tmodel.cfg)
    # a random change (a constant shift of a frame is what its LayerNorms
    # remove)
    frames[:, -1] += torch.from_numpy(_frames(tmodel.cfg, 4)[:, 0])
    b, _ = encdec.decode(tparams, tok, tmodel.encode(tparams, frames),
                         tmodel.cfg)
    assert float((a - b).abs().max()) > 1e-4


def test_full_width_config_is_the_reference():
    cfg = get_config(ARCH)
    assert (cfg.family, cfg.n_layers, cfg.n_encoder_layers, cfg.d_model,
            cfg.n_heads, cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size,
            cfg.encoder_frames, cfg.mlp_act) == (
        "encdec", 4, 4, 384, 6, 64, 1536, 51865, 1500, "gelu")
