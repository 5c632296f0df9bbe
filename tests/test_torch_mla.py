"""The port's MLA attention (deepseek-v2) against the JAX package, on the
CPU.

* The twin of tests/test_model_equivalences.py's "absorbed decode matches
  the naive block" on the port's own parameters (1e-5, as there).
* ``mla_block``'s naive prefill, its absorbed decode and the latent cache
  against ``repro.models.mla`` on the reference's parameters carried by
  ``params_from_jax`` (1e-5: one block in f32).
* Reduced deepseek-v2-236b (f32, f32 cache; one leading dense layer with
  MLA, then MoE layers): prefill and decode logits and caches at its 8
  experts (the dense oracle) and at 20 (the capacity path), rtol = atol =
  1e-4 as in tests/test_torch_model.py.
* Its stage functions against ``repro.serving.staging`` at 1 dense + 4
  MoE layers, R4 included: the boundaries run over all 5 layers and slice
  only the 4 stacked MoE layers, so the last stage holds none and the
  dense layer never runs staged (ROADMAP.md §3). The reference's empty
  stage raises; the port's passes the hidden state on to the logits, and
  the chain equals the MoE layers run unstaged on the oracle.
* A staged decode served by the port's realtime server on the CPU, whose
  payload chain gives the reference's stage chain (its first three stages,
  then the final norm and logits) on the same weights.
* The twin of tests/test_model_equivalences.py's full-model decode
  consistency for deepseek (5e-2 and the same argmax, as there).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as jax_get_reduced  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import mla as jax_mla  # noqa: E402
from repro.models.layers import InitCtx  # noqa: E402
from repro.models import transformer as jax_transformer  # noqa: E402
from repro.serving import staging as jax_staging  # noqa: E402

import repro_torch.api as api  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.models import attention, build_model, mla  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serving import staging  # noqa: E402
from repro_torch.serving.engine import staged_lm_taskspec  # noqa: E402
from test_torch_model import _np, assert_tree_close  # noqa: E402

ARCH = "deepseek-v2-236b"
BLOCK_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
N_STAGES, BATCH, PROMPT = 4, 2, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_absorbed_decode_matches_naive_block():
    """Twin of test_model_equivalences.py's MLA test, on the port's init:
    the prefill and the absorbed decode give the naive block's rows."""
    cfg = get_reduced(ARCH)
    p = mla.init_mla(torch.Generator().manual_seed(0), cfg, torch.float32)
    b, s = 2, 12
    x = torch.from_numpy(_x(1, b, s + 1, cfg.d_model))
    y_full, none = mla.mla_block(p, x, cfg=cfg,
                                 positions=torch.arange(s + 1))
    assert none is None
    cache = mla.make_mla_cache(b, s + 1, cfg, torch.float32)
    y_pre, cache = mla.mla_block(p, x[:, :s], cfg=cfg,
                                 positions=torch.arange(s), cache=cache)
    y_dec, cache = mla.mla_block(p, x[:, s:], cfg=cfg,
                                 positions=torch.tensor([s]), cache=cache)
    torch.testing.assert_close(y_pre, y_full[:, :s], **BLOCK_TOL)
    torch.testing.assert_close(y_dec[:, 0], y_full[:, s], **BLOCK_TOL)
    assert int(cache["length"]) == s + 1
    assert cache["slots_pos"].tolist() == list(range(s + 1))


def test_mla_block_and_cache_match_reference():
    cfg = get_reduced(ARCH)
    jp = jax_mla.init_mla(InitCtx(jax.random.PRNGKey(0), jnp.float32),
                          jax_get_reduced(ARCH))
    tp = params_from_jax(jax.device_get(jp), device="cpu")
    b, s, t = 2, 7, 10
    x = _x(2, b, s + 1, cfg.d_model)
    jcache = jax_mla.make_mla_cache(b, t, cfg, "float32")
    tcache = mla.make_mla_cache(b, t, cfg, torch.float32)
    jy, jcache = jax_mla.mla_block(jp, jnp.asarray(x[:, :s]), cfg=cfg,
                                   positions=jnp.arange(s), cache=jcache)
    ty, tcache = mla.mla_block(tp, torch.from_numpy(x[:, :s]), cfg=cfg,
                               positions=torch.arange(s), cache=tcache)
    assert_tree_close(ty, jy, **BLOCK_TOL)
    assert_tree_close(tcache, jax.device_get(jcache), **BLOCK_TOL)
    jy, jcache = jax_mla.mla_block(jp, jnp.asarray(x[:, s:]), cfg=cfg,
                                   positions=jnp.asarray([s]), cache=jcache)
    ty, tcache = mla.mla_block(tp, torch.from_numpy(x[:, s:]), cfg=cfg,
                               positions=torch.tensor([s]), cache=tcache)
    assert_tree_close(ty, jy, **BLOCK_TOL)
    assert_tree_close(tcache, jax.device_get(jcache), **BLOCK_TOL)
    # no cache: the naive path alone
    jy, _ = jax_mla.mla_block(jp, jnp.asarray(x), cfg=cfg,
                              positions=jnp.arange(s + 1))
    ty, _ = mla.mla_block(tp, torch.from_numpy(x), cfg=cfg,
                          positions=torch.arange(s + 1))
    assert_tree_close(ty, jy, **BLOCK_TOL)


def test_cache_write_clamps_at_the_end():
    """A block written past the buffer's end lands at the last slots that
    hold it, as ``lax.dynamic_update_slice`` clamps it."""
    cfg = get_reduced(ARCH)
    cache = mla.make_mla_cache(1, 6, cfg, torch.float32)
    cache["length"] = torch.tensor(4, dtype=torch.int32)
    val = torch.ones((1, 3, cfg.kv_lora_rank))
    out = attention.write_slots(cache["latent"], val, torch.tensor(4), 1)
    assert out[0, :, 0].tolist() == [0, 0, 0, 1, 1, 1]
    jout = jax.lax.dynamic_update_slice_in_dim(
        jnp.zeros((1, 6, cfg.kv_lora_rank)), jnp.ones((1, 3,
                                                        cfg.kv_lora_rank)),
        4, 1)
    np.testing.assert_array_equal(_np(out), np.asarray(jout))


@functools.lru_cache(maxsize=None)
def _pair_cached(replace):
    replace = dict(replace)
    jcfg = jax_get_reduced(ARCH).replace(**replace)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init_params(0)
    tmodel = build_model(get_reduced(ARCH).replace(**replace), device="cpu")
    tparams = params_from_jax(jax.device_get(jparams), device="cpu")
    return jcfg, jmodel, jparams, tmodel, tparams


def _pair(**replace):
    """Reduced deepseek-v2 in both packages with the reference's
    parameters, its caches in f32 (built once a configuration)."""
    replace.setdefault("kv_cache_dtype", "float32")
    return _pair_cached(tuple(sorted(replace.items())))


def test_parameter_and_cache_trees_match_reference():
    jcfg, jmodel, jparams, tmodel, tparams = _pair()

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, list):
            return [shapes(v) for v in t]
        return tuple(t.shape)
    assert shapes(tmodel.init_params(0)) == shapes(jax.device_get(jparams))
    assert set(tparams["dense_layers"][0]["attn"]) == {
        "q_down", "q_norm", "q_up", "kv_down", "kv_norm", "k_up", "v_up",
        "wo"}
    assert shapes(tmodel.init_cache(2, 5)) == shapes(
        jax.device_get(jmodel.init_cache(2, 5)))


@pytest.mark.parametrize("n_experts", [8, 20], ids=["oracle", "capacity"])
def test_prefill_and_decode_match_reference(n_experts):
    jcfg, jmodel, jparams, tmodel, tparams = _pair(n_experts=n_experts)
    assert transformer.default_moe_oracle(tmodel.cfg) == (n_experts <= 16)
    tokens = np.random.default_rng(n_experts).integers(
        0, jcfg.vocab_size, (BATCH, PROMPT + 1))
    jl, jc = jmodel.prefill(jparams, {
        "tokens": jnp.asarray(tokens[:, :PROMPT]),
        "cache": jmodel.init_cache(BATCH, PROMPT + 1)})
    tl, tc = tmodel.prefill(tparams, {
        "tokens": torch.from_numpy(tokens[:, :PROMPT]),
        "cache": tmodel.init_cache(BATCH, PROMPT + 1)})
    assert set(tc) == {"layers", "dense_layers"}
    assert set(tc["layers"]) == {"latent", "k_rope", "slots_pos", "length"}
    assert_tree_close(tl, jl, **MODEL_TOL)
    ref = jax.device_get(jc)
    assert_tree_close(tc["layers"], ref["layers"], **MODEL_TOL)
    assert_tree_close(tc["dense_layers"][0], ref["dense_layers"][0],
                      **MODEL_TOL)
    jd, jc2 = jmodel.decode_step(jparams, {
        "tokens": jnp.asarray(tokens[:, PROMPT:]), "cache": jc})
    td, tc2 = tmodel.decode_step(tparams, {
        "tokens": torch.from_numpy(tokens[:, PROMPT:]), "cache": tc})
    assert_tree_close(td, jd, **MODEL_TOL)
    ref = jax.device_get(jc2)
    assert_tree_close(tc2["layers"], ref["layers"], **MODEL_TOL)
    assert_tree_close(tc2["dense_layers"][0], ref["dense_layers"][0],
                      **MODEL_TOL)
    assert int(tc2["layers"]["length"][0]) == PROMPT + 1


@pytest.fixture(scope="module")
def staged_pair():
    """1 dense + 4 MoE layers, as the card's staged run cuts it."""
    jcfg, jmodel, jparams, tmodel, tparams = _pair(n_layers=5)
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


@pytest.mark.parametrize("upto", range(N_STAGES - 1))
def test_stage_functions_match_reference(staged_pair, upto):
    """Stages 0..upto chained in both packages (the last stage, which
    holds no layer, is R4's test below)."""
    (jh, jsl), (th, tsl) = _chain(staged_pair, upto)
    assert_tree_close(th, jh, **MODEL_TOL)
    assert_tree_close(tsl, jax.device_get(jsl), **MODEL_TOL)


def test_staging_reproduces_r4(staged_pair):
    """R4: bounds over all 5 layers, slices of the 4 stacked ones. The last
    stage holds no layer: the reference's scan cannot index the empty
    stack and raises, the port's stage passes the hidden state through to
    the logits. The staged chain skips the dense layer, so it is not the
    unstaged decode."""
    p = staged_pair
    cfg = p["tmodel"].cfg
    assert staging.stage_boundaries(cfg.n_layers, N_STAGES) == [
        (0, 2), (2, 3), (3, 4), (4, 5)]
    tdonor = params_from_jax(p["jdonor"], device="cpu")
    last = staging.slice_cache(cfg, tdonor, N_STAGES - 1, N_STAGES)
    assert last["latent"].shape[0] == 0
    with pytest.raises(TypeError, match="slice_sizes"):
        _chain(p, N_STAGES - 1)
    (jh, _), (th, tsl) = _chain(p, N_STAGES - 2)
    fns = staging.make_lm_stage_fns(p["tmodel"], n_stages=N_STAGES)
    out, sl = fns[-1](p["tparams"], th, last,
                      torch.tensor([PROMPT], dtype=torch.int32))
    assert sl is last
    assert_tree_close(out, jax_transformer._logits(p["jparams"],
                                                   p["jmodel"].cfg, jh),
                      **MODEL_TOL)
    zeros = torch.zeros((BATCH, 1), dtype=torch.int32)
    ref, _ = transformer.forward(p["tparams"], cfg, zeros, cache=tdonor,
                                 moe_oracle=True)
    assert float((out - ref).abs().max()) > 1e-2
    # what the chain is: the MoE layers unstaged on the oracle over the
    # donor's cache, the dense layer skipped
    x, _, _ = transformer.run_layers(
        p["tparams"]["layers"], transformer.embed(p["tparams"], cfg, zeros),
        cfg, torch.tensor([PROMPT], dtype=torch.int32), tdonor["layers"],
        moe_oracle=True)
    assert_tree_close(out, transformer.logits(p["tparams"], cfg, x),
                      **MODEL_TOL)


def test_staged_decode_served_on_cpu_gives_reference_chain(staged_pair):
    """A staged deepseek decode task on the reference's weights served by
    ServerConfig.realtime on the CPU; its payload chain (from the port's
    own donor prefill) gives the reference's stage chain."""
    p = staged_pair
    model, params = p["tmodel"], p["tparams"]
    spec = staged_lm_taskspec(model, priority=api.HP, jps=10.0,
                              n_stages=N_STAGES, prompt_len=PROMPT,
                              batch=BATCH, tag="-hp", device="cpu",
                              params=params)
    srv = (api.ServerConfig.realtime(device="cpu").tasks([spec])
           .contexts(2).oversubscribe(2.0)
           .device(api.DeviceModel(n_units=2.0)).horizon_ms(600.0).build())
    m = srv.run()
    assert m.completed[api.HP] > 0
    assert srv.backend.worker_exceptions == 0
    state = None
    for st in spec.stages:
        state = st.payload(state)
    (jh, _), _ = _chain(p, N_STAGES - 2)        # the last stage: R4
    assert_tree_close(state["hidden"],
                      jax_transformer._logits(p["jparams"], p["jmodel"].cfg,
                                              jh), **MODEL_TOL)


def test_full_model_decode_consistency():
    """Twin of test_model_equivalences.py's consistency test for deepseek:
    prefill(s) + decode(1) tracks the full forward at position s."""
    cfg = get_reduced(ARCH)
    m = build_model(cfg, device="cpu")
    params = m.init_params(0)
    b, s = 2, 12
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, s + 1)))
    full, _ = transformer.forward(params, cfg, tokens)
    _, cache = m.prefill(params, {"tokens": tokens[:, :s],
                                  "cache": m.init_cache(b, s + 1)})
    dec, _ = m.decode_step(params, {"tokens": tokens[:, s:],
                                    "cache": cache})
    a, d = full[:, -1].numpy(), dec[:, 0].numpy()
    assert np.max(np.abs(a - d)) < 5e-2
    assert (np.argmax(a, -1) == np.argmax(d, -1)).all()


def test_full_width_config_is_the_reference():
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.q_lora_rank,
            cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
            cfg.v_head_dim, cfg.n_experts, cfg.n_experts_active,
            cfg.moe_d_ff, cfg.shared_d_ff, cfg.d_ff, cfg.vocab_size,
            cfg.n_dense_layers) == (
        60, 5120, 128, 1536, 512, 128, 64, 128, 160, 6, 1536, 3072, 12288,
        102400, 1)
    assert cfg.use_mla and not transformer.default_moe_oracle(cfg)
