"""The port's hybrid family (zamba2) against the JAX package, on the CPU.

Reduced zamba2-7b (f32; 5 Mamba2 layers with the shared attention block
after layers 1 and 3, two applications with their own KV caches; f32 KV
cache) with the reference's parameters carried over by
``params_from_jax``:

* the parameter and cache trees: the port's own init draws the
  reference's shapes (the shared block's ``ln1`` over 2d, its attention
  from 2d and ``wo`` back to d);
* plain forward, prefill and decode logits and caches, at a chunk
  multiple and at a ragged prompt, rtol = atol = 1e-4 (both f32; the two
  frameworks sum in different orders), as tests/test_torch_mamba2.py;
* the decode-consistency twin of tests/test_model_equivalences.py (prefill
  plus one decode step tracks the full forward, within 5e-2 with the same
  argmax, as there);
* staging refused with the reference's message.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as jax_get_reduced  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.serving import staging as jax_staging  # noqa: E402

from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.models import build_model, params_from_jax  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serving import staging  # noqa: E402
from test_torch_model import assert_tree_close  # noqa: E402

ARCH = "zamba2-7b"
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_get_reduced(ARCH).replace(kv_cache_dtype="float32")
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init_params(0)
    tmodel = build_model(get_reduced(ARCH).replace(kv_cache_dtype="float32"),
                         device="cpu")
    tparams = params_from_jax(jax.device_get(jparams), device="cpu")
    return dict(jcfg=jcfg, jmodel=jmodel, jparams=jparams, tmodel=tmodel,
                tparams=tparams)


def test_params_and_cache_trees_match_the_reference(pair):
    cfg = pair["tmodel"].cfg
    ours = pair["tmodel"].init_params(0)
    jshapes = jax.tree.map(lambda a: tuple(a.shape), pair["jparams"])
    assert jax.tree.map(lambda a: tuple(a.shape), ours) == jshapes
    sa = ours["shared_attn"]
    d, hd = cfg.d_model, cfg.resolved_head_dim
    assert sa["ln1"].shape == (2 * d,) and sa["ln2"].shape == (d,)
    assert sa["attn"]["wq"].shape == (2 * d, cfg.n_heads, hd)
    assert sa["attn"]["wo"].shape == (cfg.n_heads, hd, d)
    assert_tree_close(pair["tparams"], jax.device_get(pair["jparams"]),
                      rtol=0, atol=0)
    cache = pair["tmodel"].init_cache(2, 9)
    assert set(cache) == {"mamba", "attn"}
    assert cache["attn"]["k"].shape[0] == cfg.n_layers // cfg.attn_every
    assert_tree_close(cache, jax.device_get(pair["jmodel"].init_cache(2, 9)))


def test_plain_forward_matches_the_reference(pair):
    tokens = np.random.default_rng(1).integers(0, pair["jcfg"].vocab_size,
                                               (2, 11))
    jl, _, _ = pair["jmodel"]._lm_forward(pair["jparams"],
                                          {"tokens": jnp.asarray(tokens)})
    tl, cache = transformer.forward(pair["tparams"], pair["tmodel"].cfg,
                                    torch.from_numpy(tokens))
    assert cache is None
    assert_tree_close(tl, jl, **MODEL_TOL)


@pytest.mark.parametrize("prompt", [16, 13], ids=["chunk_multiple", "ragged"])
def test_prefill_and_decode_match_the_reference(pair, prompt):
    jm, tm = pair["jmodel"], pair["tmodel"]
    tokens = np.random.default_rng(prompt).integers(
        0, pair["jcfg"].vocab_size, (2, prompt + 1))
    jl, jc = jm.prefill(pair["jparams"], {
        "tokens": jnp.asarray(tokens[:, :prompt]),
        "cache": jm.init_cache(2, prompt + 1)})
    tl, tc = tm.prefill(pair["tparams"], {
        "tokens": torch.from_numpy(tokens[:, :prompt]),
        "cache": tm.init_cache(2, prompt + 1)})
    assert_tree_close(tl, jl, **MODEL_TOL)
    assert_tree_close(tc, jax.device_get(jc), **MODEL_TOL)
    jd, jc2 = jm.decode_step(pair["jparams"], {
        "tokens": jnp.asarray(tokens[:, prompt:]), "cache": jc})
    td, tc2 = tm.decode_step(pair["tparams"], {
        "tokens": torch.from_numpy(tokens[:, prompt:]), "cache": tc})
    assert_tree_close(td, jd, **MODEL_TOL)
    assert_tree_close(tc2, jax.device_get(jc2), **MODEL_TOL)
    assert int(tc2["mamba"]["length"][0]) == prompt + 1
    assert (tc2["attn"]["length"] == prompt + 1).all()


def test_full_model_decode_consistency():
    """Twin of tests/test_model_equivalences.py's test, for zamba2-7b:
    prefill(s) + decode(1) tracks the full forward at position s."""
    cfg = get_reduced(ARCH)
    m = build_model(cfg, device="cpu")
    params = m.init_params(0)
    rng = np.random.default_rng(0)
    b, s = 2, 12
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s + 1)))
    logits_full, _ = transformer.forward(params, cfg, tokens)
    _, cache = m.prefill(params, {"tokens": tokens[:, :s],
                                  "cache": m.init_cache(b, s + 1)})
    logits_dec, _ = m.decode_step(params, {"tokens": tokens[:, s:s + 1],
                                           "cache": cache})
    a = logits_full[:, -1].numpy()
    d = logits_dec[:, 0].float().numpy()
    assert np.max(np.abs(a - d)) < 5e-2
    assert (np.argmax(a, -1) == np.argmax(d, -1)).all()


def test_staging_is_refused_with_the_reference_message(pair):
    with pytest.raises(NotImplementedError) as ours:
        staging.make_lm_stage_fns(pair["tmodel"], n_stages=4)
    with pytest.raises(NotImplementedError) as ref:
        jax_staging.make_lm_stage_fns(pair["jmodel"], n_stages=4)
    assert str(ours.value) == str(ref.value)


def test_full_width_config_is_the_reference():
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.resolved_head_dim,
            cfg.d_inner, cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state,
            cfg.attn_every, cfg.n_layers // cfg.attn_every) == (
        81, 3584, 32, 112, 7168, 112, 64, 64, 6, 13)
