"""The port's gemma2 family against the JAX package, on the CPU.

Reduced gemma2-27b (f32 weights and f32 KV cache; window 16, so a prompt
of 20 tokens and the decode steps after it wrap the local layers' ring
cache) with the reference's parameters carried by ``params_from_jax``:
the plain forward, prefill and three decode steps (logits and caches),
the local/global cache structure (twin of
tests/test_model_equivalences.py's), the stage functions against
``repro.serving.staging`` (its stages cut over blocks of a local and a
global layer), and the staged chain against the unstaged decode. rtol =
atol = 1e-4 as in tests/test_torch_model.py.
"""
import functools

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

ARCH = "gemma2-27b"
TOL = dict(rtol=1e-4, atol=1e-4)
N_STAGES, BATCH = 4, 2
PROMPT = 20                      # past the reduced window of 16
STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _pair_cached(n_layers):
    replace = dict(kv_cache_dtype="float32", n_layers=n_layers)
    jcfg = jax_get_reduced(ARCH).replace(**replace)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init_params(0)
    tmodel = build_model(get_reduced(ARCH).replace(**replace), device="cpu")
    tparams = params_from_jax(jax.device_get(jparams), device="cpu")
    return jcfg, jmodel, jparams, tmodel, tparams


def test_local_global_cache_structure():
    """Twin of test_model_equivalences.py's gemma2 cache test."""
    cfg = get_reduced(ARCH)
    cache = build_model(cfg, device="cpu").init_cache(2, 64)
    assert set(cache) == {"local", "global"}
    # the local ring capped at the sliding window
    assert cache["local"]["k"].shape[2] == cfg.sliding_window
    assert cache["global"]["k"].shape[2] == 64
    assert cache["local"]["k"].shape[0] == cfg.n_layers // 2


def test_parameter_tree_matches_reference():
    _, _, jparams, tmodel, tparams = _pair_cached(4)

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        return tuple(t.shape)
    assert shapes(tmodel.init_params(0)) == shapes(jax.device_get(jparams))
    assert set(tparams["layers"]["local"]) == {
        "ln1", "attn", "ln2", "mlp", "ln1_post", "ln2_post"}


def test_forward_matches_reference():
    jcfg, jmodel, jparams, tmodel, tparams = _pair_cached(4)
    tokens = np.random.default_rng(3).integers(0, jcfg.vocab_size,
                                               (BATCH, 24))
    jl, _, _ = jmodel._lm_forward(jparams, {"tokens": jnp.asarray(tokens)})
    tl, none = transformer.forward(tparams, tmodel.cfg,
                                   torch.from_numpy(tokens))
    assert none is None
    assert_tree_close(tl, jl, **TOL)
    # the final softcap bounds every logit
    assert float(tl.abs().max()) < tmodel.cfg.logit_softcap


def test_prefill_and_decode_through_the_ring_match_reference():
    jcfg, jmodel, jparams, tmodel, tparams = _pair_cached(4)
    tokens = np.random.default_rng(5).integers(0, jcfg.vocab_size,
                                               (BATCH, PROMPT + STEPS))
    t = PROMPT + STEPS
    jl, jc = jmodel.prefill(jparams, {
        "tokens": jnp.asarray(tokens[:, :PROMPT]),
        "cache": jmodel.init_cache(BATCH, t)})
    tl, tc = tmodel.prefill(tparams, {
        "tokens": torch.from_numpy(tokens[:, :PROMPT]),
        "cache": tmodel.init_cache(BATCH, t)})
    assert_tree_close(tl, jl, **TOL)
    assert_tree_close(tc, jax.device_get(jc), **TOL)
    # the ring holds the window's tail: positions 4..19 in slots 0..15
    assert tc["local"]["slots_pos"][0].tolist() == list(range(4, PROMPT))
    for i in range(PROMPT, t):
        jl, jc = jmodel.decode_step(jparams, {
            "tokens": jnp.asarray(tokens[:, i:i + 1]), "cache": jc})
        tl, tc = tmodel.decode_step(tparams, {
            "tokens": torch.from_numpy(tokens[:, i:i + 1]), "cache": tc})
        assert_tree_close(tl, jl, **TOL)
        assert_tree_close(tc, jax.device_get(jc), **TOL)
    # position p lands in slot p % 16: the wrap overwrote slots 4..6
    slots = tc["local"]["slots_pos"][0].tolist()
    assert slots[4:7] == [PROMPT, PROMPT + 1, PROMPT + 2]
    assert int(transformer.cache_length(tmodel.cfg, tc)) == t


@pytest.fixture(scope="module")
def staged_pair():
    """8 layers: 4 (local, global) blocks, one a stage."""
    jcfg, jmodel, jparams, tmodel, tparams = _pair_cached(8)
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size,
                                               (BATCH, PROMPT))
    _, jdonor = jmodel.prefill(jparams, {
        "tokens": jnp.asarray(tokens),
        "cache": jmodel.init_cache(BATCH, PROMPT + 1)})
    return dict(jmodel=jmodel, jparams=jparams, tmodel=tmodel,
                tparams=tparams, jdonor=jax.device_get(jdonor))


def _chain(p, upto):
    jfns = jax_staging.make_lm_stage_fns(p["jmodel"], n_stages=N_STAGES)
    tfns = staging.make_lm_stage_fns(p["tmodel"], n_stages=N_STAGES)
    jdonor = jax.tree.map(jnp.asarray, p["jdonor"])
    tdonor = params_from_jax(p["jdonor"], device="cpu")
    jh = jnp.zeros((BATCH, 1), jnp.int32)
    th = torch.zeros((BATCH, 1), dtype=torch.int32)
    jpos = jnp.asarray([PROMPT], jnp.int32)
    tpos = torch.tensor([PROMPT], dtype=torch.int32)
    jcfg, tcfg = p["jmodel"].cfg, p["tmodel"].cfg
    for i in range(upto + 1):
        jh, jsl = jfns[i](p["jparams"], jh,
                          jax_staging.slice_cache(jcfg, jdonor, i, N_STAGES),
                          jpos)
        th, tsl = tfns[i](p["tparams"], th,
                          staging.slice_cache(tcfg, tdonor, i, N_STAGES),
                          tpos)
    return (jh, jsl), (th, tsl)


@pytest.mark.parametrize("upto", range(N_STAGES))
def test_stage_functions_match_reference(staged_pair, upto):
    (jh, jsl), (th, tsl) = _chain(staged_pair, upto)
    assert set(tsl) == {"local", "global"}
    assert tsl["local"]["k"].shape[0] == 1          # one block a stage
    assert_tree_close(th, jh, **TOL)
    assert_tree_close(tsl, jax.device_get(jsl), **TOL)


def test_staged_chain_matches_unstaged_decode(staged_pair):
    """Gemma2 has no R4: the four stages are the whole decode step."""
    p = staged_pair
    _, (th, _) = _chain(p, N_STAGES - 1)
    tdonor = params_from_jax(p["jdonor"], device="cpu")
    ref, _ = p["tmodel"].decode_step(p["tparams"], {
        "tokens": torch.zeros((BATCH, 1), dtype=torch.int32),
        "cache": tdonor})
    torch.testing.assert_close(th, ref, rtol=1e-5, atol=1e-5)


def test_full_width_config_is_the_reference():
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size,
            cfg.sliding_window, cfg.attn_softcap, cfg.logit_softcap) == (
        46, 4608, 32, 16, 128, 36864, 256000, 4096, 50.0, 30.0)
    assert cfg.tie_embeddings and cfg.embed_scale and cfg.post_block_norms
