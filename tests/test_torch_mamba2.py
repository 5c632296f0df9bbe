"""The port's Mamba2 family against the JAX package, on the CPU.

* The SSD scan: the port's ``ssd`` (its plain version on the CPU) against
  the JAX package's ``ops.ssd`` through the Pallas kernel in interpret mode
  and through its reference, at tests/test_kernels.py's shapes plus
  G = 2 and a non-zero initial state; tolerance 5e-4, as there.
* The chunked scan against the token-by-token recurrence (the independent
  oracle of tests/test_kernels.py), 2e-3 as there.
* Reduced mamba2-2.7b (f32) with the JAX parameters carried over by
  ``params_from_jax``: prefill logits and cache, and decode logits, at a
  chunk multiple and at a ragged prompt (padded with dt = 0 tokens inside
  the block). Both sides compute in f32 but sum in different orders:
  rtol = atol = 1e-4.
* The twin of tests/test_model_equivalences.py's decode-consistency test,
  and staged decode against unstaged decode through the port's realtime
  server.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as jax_get_reduced  # noqa: E402
from repro.kernels import ops  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models.mamba2 import ssd_decode_step as jax_decode_step  # noqa: E402

import repro_torch.api as api  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.kernels import KERNELS, reset_counts  # noqa: E402
from repro_torch.kernels import ssd_scan  # noqa: E402
from repro_torch.models import build_model, params_from_jax  # noqa: E402
from repro_torch.models.mamba2 import ssd_decode_step  # noqa: E402
from repro_torch.serving.engine import staged_lm_taskspec  # noqa: E402
from test_torch_model import assert_tree_close  # noqa: E402

ARCH = "mamba2-2.7b"
SSD_TOL = dict(rtol=5e-4, atol=5e-4)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ssd_inputs(rng, bs, ln, h, p, g, n, al_hi=1.5, init=False):
    arrs = {"x": rng.standard_normal((bs, ln, h, p)).astype(np.float32),
            "dt": rng.uniform(0.001, 0.1, (bs, ln, h)).astype(np.float32),
            "a_log": rng.uniform(-0.5, al_hi, (h,)).astype(np.float32),
            "b": rng.standard_normal((bs, ln, g, n)).astype(np.float32),
            "c": rng.standard_normal((bs, ln, g, n)).astype(np.float32)}
    arrs["init_state"] = (rng.standard_normal((bs, h, p, n)).astype(
        np.float32) if init else None)
    return arrs


def run_ssd(arrs, chunk):
    ours = ssd_scan.ssd(*(torch.from_numpy(arrs[k])
                          for k in ("x", "dt", "a_log", "b", "c")),
                        chunk=chunk,
                        init_state=(None if arrs["init_state"] is None else
                                    torch.from_numpy(arrs["init_state"])))
    ins = [jnp.asarray(arrs[k]) for k in ("x", "dt", "a_log", "b", "c")]
    s0 = None if arrs["init_state"] is None else jnp.asarray(
        arrs["init_state"])
    kern = ops.ssd(*ins, chunk=chunk, init_state=s0, mode="kernel")
    ref = ops.ssd(*ins, chunk=chunk, init_state=s0, mode="ref")
    return ours, kern, ref


@pytest.mark.parametrize("l,h,p,n,chunk,g,init", [
    (256, 4, 32, 16, 64, 1, False), (512, 2, 64, 32, 128, 1, False),
    (128, 8, 16, 16, 32, 1, False), (128, 4, 16, 16, 32, 2, False),
    (128, 4, 16, 16, 32, 1, True), (96, 6, 8, 16, 32, 2, True)])
def test_ssd_matches_pallas_kernel_and_reference(l, h, p, n, chunk, g, init):
    rng = np.random.default_rng(5)
    arrs = ssd_inputs(rng, 2, l, h, p, g, n, init=init)
    reset_counts()
    (y, s), kern, ref = run_ssd(arrs, chunk)
    assert KERNELS["ssd"].counts.plain_calls == 1
    for want in (kern, ref):
        np.testing.assert_allclose(y.numpy(), np.asarray(want[0]), **SSD_TOL)
        np.testing.assert_allclose(s.numpy(), np.asarray(want[1]), **SSD_TOL)


def test_ssd_matches_sequential_recurrence():
    """Chunked SSD == token-by-token recurrence (independent oracle), and
    the port's recurrence step == the JAX package's."""
    rng = np.random.default_rng(6)
    arrs = ssd_inputs(rng, 1, 64, 2, 8, 1, 8, al_hi=1.0)
    t = {k: torch.from_numpy(v) for k, v in arrs.items() if v is not None}
    y_chunk, s_chunk = ssd_scan.ssd(t["x"], t["dt"], t["a_log"], t["b"],
                                    t["c"], chunk=16)
    state = torch.zeros((1, 2, 8, 8))
    jstate = jnp.zeros((1, 2, 8, 8), jnp.float32)
    ys = []
    for i in range(64):
        y_t, state = ssd_decode_step(state, t["x"][:, i], t["dt"][:, i],
                                     t["a_log"], t["b"][:, i], t["c"][:, i])
        jy, jstate = jax_decode_step(jstate, *(jnp.asarray(arrs[k][:, i])
                                               for k in ("x", "dt")),
                                     jnp.asarray(arrs["a_log"]),
                                     *(jnp.asarray(arrs[k][:, i])
                                       for k in ("b", "c")))
        np.testing.assert_allclose(y_t.numpy(), np.asarray(jy), rtol=1e-5,
                                   atol=1e-5)
        ys.append(y_t)
    y_seq = torch.stack(ys, dim=1)
    np.testing.assert_allclose(y_chunk.numpy(), y_seq.numpy(), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(s_chunk.numpy(), state.numpy(), rtol=2e-3,
                               atol=2e-3)


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_get_reduced(ARCH)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init_params(0)
    tmodel = build_model(get_reduced(ARCH), device="cpu")
    tparams = params_from_jax(jax.device_get(jparams), device="cpu")
    return dict(jcfg=jcfg, jmodel=jmodel, jparams=jparams, tmodel=tmodel,
                tparams=tparams)


def test_params_and_cache_trees_match_the_reference(pair):
    cfg = pair["tmodel"].cfg
    assert cfg.tie_embeddings and "lm_head" not in pair["tparams"]
    ours = pair["tmodel"].init_params(0)
    jshapes = jax.tree.map(lambda a: tuple(a.shape), pair["jparams"])
    tshapes = jax.tree.map(lambda a: tuple(a.shape), ours)
    assert tshapes == jshapes
    jcache = jax.device_get(pair["jmodel"].init_cache(2, 9))
    assert_tree_close(pair["tmodel"].init_cache(2, 9), jcache)
    # the A_log init of the reference: log(linspace(1, 16, H)) per layer
    np.testing.assert_allclose(ours["layers"]["mamba"]["A_log"].numpy(),
                               np.asarray(pair["jparams"]["layers"]["mamba"]
                                          ["A_log"]), rtol=1e-6)


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
    assert int(tc2["length"][0]) == prompt + 1


def test_full_model_decode_consistency():
    """Twin of tests/test_model_equivalences.py's test for mamba2-2.7b:
    prefill(s) + decode(1) tracks the full forward at position s."""
    from repro_torch.models import transformer
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
    d = logits_dec[:, 0].numpy()
    assert np.max(np.abs(a - d)) < 5e-2
    assert (np.argmax(a, -1) == np.argmax(d, -1)).all()


def test_staged_decode_matches_unstaged_under_realtime_server():
    """A staged mamba2 decode task served by ServerConfig.realtime on the
    CPU; its payload chain gives the unstaged decode_step's logits."""
    cfg = get_reduced(ARCH).replace(n_layers=4)
    model = build_model(cfg, device="cpu")
    params = model.init_params(0)
    reset_counts()
    spec = staged_lm_taskspec(model, priority=api.HP, jps=10.0, n_stages=4,
                              prompt_len=12, batch=2, tag="-hp",
                              device="cpu", params=params)
    assert KERNELS["ssd"].counts.plain_calls == cfg.n_layers   # the donor
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
    ref, _ = model.decode_step(params, {
        "tokens": torch.zeros((2, 1), dtype=torch.int32), "cache": donor})
    torch.testing.assert_close(state["hidden"], ref, rtol=1e-5, atol=1e-5)


def test_full_width_config_is_the_reference():
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.d_inner, cfg.ssm_nheads,
            cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_ngroups,
            cfg.ssm_chunk, cfg.vocab_size) == (64, 2560, 5120, 80, 64, 128,
                                               1, 256, 50280)
    assert cfg.ssm_headdim <= ssd_scan.MAX_HEADDIM
    assert cfg.ssm_state <= ssd_scan.MAX_STATE
