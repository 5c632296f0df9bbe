"""The port's MoE family against the JAX package, on the CPU.

* ``route``, ``dispatch_indices``, ``moe_dense_oracle``, ``moe_capacity``
  and the load-balance (aux) loss on the same seeded numpy inputs. Router
  inputs are continuous normal draws, so no two experts tie for a row's
  top-k (``torch.topk`` and ``lax.top_k`` may order ties differently);
  routing ids must be equal, weights and outputs agree within 1e-5 (f32;
  the frameworks sum in different orders).
* The twin of tests/test_arch_smoke.py's "capacity matches the oracle
  when uncapped" (2e-5, as there), padded experts through ``ep_shards``
  (never routed: their probability is 0), and ``moe_body``'s aux against
  the reference's ``_moe_body``.
* Reduced qwen2-moe-a2.7b (f32, f32 KV cache) with the reference's
  parameters carried over by ``params_from_jax``: prefill and decode
  logits and caches at its 8 experts (the dense oracle by default) and at
  20 (the capacity path, with drops), rtol = atol = 1e-4 as in
  tests/test_torch_model.py; the 4 stage functions against ``repro.serving.staging``; and a staged decode
  served by the port's realtime server on the CPU, whose payload chain
  gives the unstaged ``forward(..., moe_oracle=True)`` decode.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as jax_get_reduced  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models import transformer as jax_transformer  # noqa: E402
from repro.serving import staging as jax_staging  # noqa: E402

import repro_torch.api as api  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.models import build_model, moe, params_from_jax  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serving import staging  # noqa: E402
from repro_torch.serving.engine import staged_lm_taskspec  # noqa: E402
from test_torch_model import _np, assert_tree_close  # noqa: E402

ARCH = "qwen2-moe-a2.7b"
TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
N_LAYERS, N_STAGES, BATCH, PROMPT = 4, 4, 2, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def moe_params(rng, d, e, f, shared=0):
    p = {"router": rng.standard_normal((d, e)) / np.sqrt(d),
         "experts": {"w_gate": rng.standard_normal((e, d, f)) / np.sqrt(d),
                     "w_up": rng.standard_normal((e, d, f)) / np.sqrt(d),
                     "w_down": rng.standard_normal((e, f, d)) / np.sqrt(f)}}
    if shared:
        p["shared"] = {"w_gate": rng.standard_normal((d, shared)) / np.sqrt(d),
                       "w_up": rng.standard_normal((d, shared)) / np.sqrt(d),
                       "w_down": rng.standard_normal((shared, d))
                       / np.sqrt(shared)}
    return jax.tree.map(lambda a: a.astype(np.float32), p)


def both(tree):
    """The same numpy tree as JAX arrays and as CPU tensors."""
    return (jax.tree.map(jnp.asarray, tree),
            params_from_jax(tree, device="cpu"))


@pytest.mark.parametrize("e,k,norm,n_valid", [(8, 2, False, None),
                                              (60, 4, True, None),
                                              (64, 4, True, 60),
                                              (9, 3, False, 6)])
def test_route_matches_reference(e, k, norm, n_valid):
    rng = np.random.default_rng(e + k)
    w = (rng.standard_normal((32, e)) / 4).astype(np.float32)
    x = rng.standard_normal((40, 32)).astype(np.float32)
    ours = moe.route(torch.from_numpy(w), torch.from_numpy(x), k, norm,
                     n_valid)
    ref = jax_moe.route(jnp.asarray(w), jnp.asarray(x), k, norm, n_valid)
    np.testing.assert_allclose(_np(ours[0]), np.asarray(ref[0]), **TOL)
    np.testing.assert_array_equal(_np(ours[1]), np.asarray(ref[1]))
    assert ours[1].dtype == torch.int32
    np.testing.assert_allclose(_np(ours[2]), np.asarray(ref[2]), **TOL)
    if n_valid is not None:
        assert int(ours[1].max()) < n_valid
        assert float(ours[2][:, n_valid:].abs().max()) == 0.0
    np.testing.assert_allclose(
        float(moe.load_balance_loss(ours[2], ours[1], n_valid or e)),
        float(jax_moe.load_balance_loss(ref[2], ref[1], n_valid or e)),
        **TOL)


@pytest.mark.parametrize("capacity,e", [(2, 8), (5, 8), (1, 8), (3, 12)])
def test_dispatch_indices_match_reference(capacity, e):
    """Slots, weights and validity over all ``e`` experts, with drops past
    capacity (the reference's slice arguments at offset 0, width E)."""
    rng = np.random.default_rng(capacity + e)
    ids = np.stack([rng.choice(e, 2, replace=False) for _ in range(12)]
                   ).astype(np.int32)
    w = rng.uniform(0.1, 1.0, (12, 2)).astype(np.float32)
    ours = moe.dispatch_indices(torch.from_numpy(ids), torch.from_numpy(w),
                                capacity, 0, e)
    ref = jax_moe.dispatch_indices(jnp.asarray(ids), jnp.asarray(w), capacity,
                                   0, e)
    for a, b in zip(ours, ref):
        assert a.shape == b.shape
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    assert ours[0].dtype == torch.int32 and ours[2].dtype == torch.bool


@pytest.mark.parametrize("n_valid,shared", [(None, 0), (6, 24), (None, 24)])
def test_oracle_and_capacity_match_reference(n_valid, shared):
    rng = np.random.default_rng(11)
    jp, tp = both(moe_params(rng, 32, 8, 16, shared))
    x = rng.standard_normal((2, 12, 32)).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    out, aux = moe.moe_dense_oracle(tp, tx, 2, True, "silu", n_valid)
    jout, jaux = jax_moe.moe_dense_oracle(jp, jx, 2, True, "silu", n_valid)
    np.testing.assert_allclose(_np(out), np.asarray(jout), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    for cf in (1.0, 1.25, 8.0):
        out, aux = moe.moe_capacity(tp, tx, 2, capacity_factor=cf,
                                    norm_topk=True, n_valid=n_valid)
        jout, jaux = jax_moe.moe_capacity(jp, jx, 2, capacity_factor=cf,
                                          norm_topk=True, n_valid=n_valid)
        np.testing.assert_allclose(_np(out), np.asarray(jout), **TOL)
        np.testing.assert_allclose(float(aux), float(jaux), **TOL)


def test_moe_capacity_matches_oracle_when_uncapped():
    """Twin of tests/test_arch_smoke.py's test, on the port's own init."""
    gen = torch.Generator().manual_seed(0)
    p = moe.init_moe(gen, 32, 8, 16, 0, torch.float32)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 24, 32)).astype(np.float32))
    out_o, _ = moe.moe_dense_oracle(p, x, topk=2)
    # capacity large enough that nothing drops -> must match oracle
    out_c, _ = moe.moe_capacity(p, x, topk=2, capacity_factor=8.0)
    np.testing.assert_allclose(out_o.numpy(), out_c.numpy(), rtol=2e-5,
                               atol=2e-5)


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
    """Reduced qwen2-moe in both packages, the reference's parameters in
    the port's (built once a configuration). Its KV cache in f32, as in
    tests/test_torch_model.py: a bf16 cache would round the two packages'
    slightly different f32 keys to neighbouring bf16 values."""
    replace.setdefault("kv_cache_dtype", "float32")
    return _pair_cached(tuple(sorted(replace.items())))


def test_padded_experts_are_masked_from_routing():
    """``ep_shards`` 4 pads 6 experts to 8; the port's tree has the
    reference's shapes and the padding never takes a token."""
    jcfg, jmodel, jparams, tmodel, tparams = _pair(n_experts=6, ep_shards=4)
    assert transformer.moe_padded_experts(tmodel.cfg) == 8
    assert tparams["layers"]["moe"]["router"].shape == (2, 64, 8)
    shapes = jax.tree.map(lambda a: tuple(a.shape),
                          tmodel.init_params(0))
    assert shapes == jax.tree.map(lambda a: tuple(a.shape), jparams)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (10, 64)).astype(np.float32))
    _, ids, probs = moe.route(tparams["layers"]["moe"]["router"][0], x, 2,
                              True, 6)
    assert int(ids.max()) < 6 and float(probs[:, 6:].max()) == 0.0
    tokens = np.random.default_rng(4).integers(0, jcfg.vocab_size, (2, 6))
    jl, _, _ = jmodel._lm_forward(jparams, {"tokens": jnp.asarray(tokens)})
    tl, _ = transformer.forward(tparams, tmodel.cfg, torch.from_numpy(tokens))
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **MODEL_TOL)


@pytest.mark.parametrize("use_oracle", [True, False])
def test_moe_body_and_aux_match_reference(use_oracle):
    """One layer: hidden, cache and aux (the loss training will add)."""
    jcfg, jmodel, jparams, tmodel, tparams = _pair(n_experts=20)
    x = np.random.default_rng(5).standard_normal((2, 6, 64)).astype(
        np.float32)
    pos = np.arange(6, dtype=np.int32)
    jlp = jax.tree.map(lambda a: a[0], jparams["layers"])
    tlp = transformer.index_tree(tparams["layers"], 0)
    jx, _, jaux = jax_transformer._moe_body(jlp, jnp.asarray(x), jcfg,
                                            jnp.asarray(pos), None, 0,
                                            use_oracle)
    tx, _, taux = transformer.moe_body(tlp, torch.from_numpy(x), tmodel.cfg,
                                       torch.from_numpy(pos), None,
                                       use_oracle)
    np.testing.assert_allclose(_np(tx), np.asarray(jx), **MODEL_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)


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
    assert set(tc) == {"layers"}
    assert_tree_close(tl, jl, **MODEL_TOL)
    assert_tree_close(tc, jax.device_get(jc), **MODEL_TOL)
    jd, jc2 = jmodel.decode_step(jparams, {
        "tokens": jnp.asarray(tokens[:, PROMPT:]), "cache": jc})
    td, tc2 = tmodel.decode_step(tparams, {
        "tokens": torch.from_numpy(tokens[:, PROMPT:]), "cache": tc})
    assert_tree_close(td, jd, **MODEL_TOL)
    assert_tree_close(tc2, jax.device_get(jc2), **MODEL_TOL)
    assert int(tc2["layers"]["length"][0]) == PROMPT + 1


def test_leading_dense_layers_match_reference():
    """The moe family's leading dense layers (a list, outside the stack)
    with their own caches."""
    jcfg, jmodel, jparams, tmodel, tparams = _pair(n_layers=3,
                                                   n_dense_layers=1)
    assert len(tparams["dense_layers"]) == 1
    tokens = np.random.default_rng(9).integers(0, jcfg.vocab_size, (2, 5))
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens),
                                      "cache": jmodel.init_cache(2, 6)})
    tl, tc = tmodel.prefill(tparams, {"tokens": torch.from_numpy(tokens),
                                      "cache": tmodel.init_cache(2, 6)})
    assert_tree_close(tl, jl, **MODEL_TOL)
    ref = jax.device_get(jc)
    assert_tree_close(tc["layers"], ref["layers"], **MODEL_TOL)
    assert_tree_close(tc["dense_layers"][0], ref["dense_layers"][0],
                      **MODEL_TOL)


@pytest.fixture(scope="module")
def staged_pair():
    jcfg, jmodel, jparams, tmodel, tparams = _pair(n_layers=N_LAYERS,
                                                   n_experts=20)
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size,
                                               (BATCH, PROMPT))
    _, jdonor = jmodel.prefill(jparams, {
        "tokens": jnp.asarray(tokens),
        "cache": jmodel.init_cache(BATCH, PROMPT + 1)})
    return dict(jmodel=jmodel, jparams=jparams, tmodel=tmodel,
                tparams=tparams, jdonor=jax.device_get(jdonor))


@pytest.mark.parametrize("upto", range(N_STAGES))
def test_stage_functions_match_reference(staged_pair, upto):
    """Stages 0..upto chained in both packages (moe layers on the oracle,
    the cache sliced at its "layers" level)."""
    p = staged_pair
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
    assert_tree_close(th, jh, **MODEL_TOL)
    assert_tree_close(tsl, jax.device_get(jsl), **MODEL_TOL)


def test_staged_decode_matches_unstaged_oracle_under_realtime_server():
    """A staged moe decode task (20 experts: its stages take the oracle,
    its unstaged ``decode_step`` would take the capacity path) served by
    ServerConfig.realtime on the CPU; its payload chain gives the
    unstaged ``forward(..., moe_oracle=True)`` decode."""
    cfg = get_reduced(ARCH).replace(n_layers=4, n_experts=20)
    model = build_model(cfg, device="cpu")
    params = model.init_params(0)
    spec = staged_lm_taskspec(model, priority=api.HP, jps=10.0, n_stages=4,
                              prompt_len=12, batch=2, tag="-hp",
                              device="cpu", params=params)
    srv = (api.ServerConfig.realtime(device="cpu").tasks([spec])
           .contexts(2).oversubscribe(2.0)
           .device(api.DeviceModel(n_units=2.0)).horizon_ms(600.0).build())
    m = srv.run()
    assert m.completed[api.HP] > 0
    assert srv.backend.worker_exceptions == 0
    state = None
    for st in spec.stages:
        state = st.payload(state)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 12)))
    _, donor = model.prefill(params, {"tokens": tokens,
                                      "cache": model.init_cache(2, 13)})
    ref, _ = transformer.forward(params, cfg,
                                 torch.zeros((2, 1), dtype=torch.int32),
                                 cache=donor, moe_oracle=True)
    torch.testing.assert_close(state["hidden"], ref, rtol=1e-5, atol=1e-5)


def test_full_width_config_is_the_reference():
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.resolved_head_dim,
            cfg.n_experts, cfg.n_experts_active, cfg.moe_d_ff,
            cfg.shared_d_ff, cfg.vocab_size, cfg.qkv_bias) == (
        24, 2048, 16, 128, 60, 4, 1408, 5632, 151936, True)
    assert transformer.moe_padded_experts(cfg) == 60
    assert not transformer.default_moe_oracle(cfg)
