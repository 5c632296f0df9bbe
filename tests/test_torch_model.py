"""The port's dense LM against the JAX package, on the CPU.

Reduced smollm-135m (f32 weights and f32 KV cache, 4 layers so that each
of the 4 stages owns one), with the reference's own parameters carried
over leaf by leaf by ``params_from_jax`` and the same tokens made with
numpy. Prefill logits,
``decode_step`` logits, the updated caches and every stage function's
hidden state and cache slice must agree within rtol = atol = 1e-4: both
sides compute in f32, but the two frameworks sum in different orders.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as jax_get_reduced  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.serving import staging as jax_staging  # noqa: E402

from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.models import build_model, params_from_jax  # noqa: E402
from repro_torch.serving import staging  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
N_LAYERS, N_STAGES, BATCH, PROMPT = 4, 4, 2, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread keeps these tests
    from taking every core from wall-clock tests in other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:       # numpy has no bfloat16
            x = x.float()
        return x.detach().cpu().numpy()
    if x.dtype.name == "bfloat16":
        return np.asarray(x, np.float32)
    return np.asarray(x)


def assert_tree_close(ours, ref, path="", **tol):
    if isinstance(ref, dict):
        assert set(ours) == set(ref), (path, set(ours), set(ref))
        for k in ref:
            assert_tree_close(ours[k], ref[k], f"{path}/{k}", **tol)
        return
    a, b = _np(ours), _np(ref)
    assert a.shape == b.shape, (path, a.shape, b.shape)
    if np.issubdtype(b.dtype, np.integer):
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        np.testing.assert_allclose(a, b, err_msg=path, **(tol or TOL))


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_get_reduced("smollm-135m").replace(n_layers=N_LAYERS,
                                                   kv_cache_dtype="float32")
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init_params(0)
    tmodel = build_model(get_reduced("smollm-135m").replace(
        n_layers=N_LAYERS, kv_cache_dtype="float32"), device="cpu")
    tparams = params_from_jax(jax.device_get(jparams), device="cpu")
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size,
                                               (BATCH, PROMPT))
    jlogits, jdonor = jmodel.prefill(
        jparams, {"tokens": jnp.asarray(tokens),
                  "cache": jmodel.init_cache(BATCH, PROMPT + 1)})
    return dict(jmodel=jmodel, jparams=jparams, tmodel=tmodel,
                tparams=tparams, tokens=tokens, jlogits=jlogits,
                jdonor=jax.device_get(jdonor))


def test_params_from_jax_keeps_tree_and_layouts(pair):
    ref = jax.device_get(pair["jparams"])
    assert_tree_close(pair["tparams"], ref, rtol=0, atol=0)
    assert pair["tparams"]["layers"]["attn"]["wq"].shape == (
        N_LAYERS, 64, 4, 16)


def test_init_params_tree_matches_reference(pair):
    """The port's own init draws a tree of the same shapes and dtypes."""
    ours = pair["tmodel"].init_params(0)
    ref = jax.device_get(pair["jparams"])

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        return (tuple(t.shape), str(_np(t).dtype))
    assert shapes(ours) == shapes(ref)
    # embeddings N(0, 0.02); dense weights truncated at 2 std of 1/sqrt(fan_in)
    assert abs(float(ours["embed"].std()) - 0.02) < 2e-3
    wq = ours["layers"]["attn"]["wq"]
    assert float(wq.abs().max()) <= 2.0 / np.sqrt(64) + 1e-6


def test_prefill_logits_and_cache(pair):
    tm = pair["tmodel"]
    logits, cache = tm.prefill(
        pair["tparams"], {"tokens": torch.from_numpy(pair["tokens"]),
                          "cache": tm.init_cache(BATCH, PROMPT + 1)})
    assert_tree_close(logits, pair["jlogits"])
    assert_tree_close(cache, pair["jdonor"])


def test_decode_step_logits_and_cache(pair):
    jm, tm = pair["jmodel"], pair["tmodel"]
    tok = np.full((BATCH, 1), 3, np.int64)
    jl, jc = jm.decode_step(pair["jparams"],
                            {"tokens": jnp.asarray(tok),
                             "cache": jax.tree.map(jnp.asarray,
                                                   pair["jdonor"])})
    donor = params_from_jax(pair["jdonor"], device="cpu")
    tl, tc = tm.decode_step(pair["tparams"],
                            {"tokens": torch.from_numpy(tok), "cache": donor})
    assert_tree_close(tl, jl)
    assert_tree_close(tc, jax.device_get(jc))
    # functional update: the donor the step read is untouched
    assert_tree_close(donor, pair["jdonor"], rtol=0, atol=0)


@pytest.mark.parametrize("upto", range(N_STAGES))
def test_stage_functions_match_reference(pair, upto):
    """Stages 0..upto chained in both packages: each stage's output hidden
    state (logits for the last) and updated cache slice agree."""
    jfns = jax_staging.make_lm_stage_fns(pair["jmodel"], n_stages=N_STAGES)
    tfns = staging.make_lm_stage_fns(pair["tmodel"], n_stages=N_STAGES)
    jdonor = jax.tree.map(jnp.asarray, pair["jdonor"])
    tdonor = params_from_jax(pair["jdonor"], device="cpu")
    jh = jnp.zeros((BATCH, 1), jnp.int32)
    th = torch.zeros((BATCH, 1), dtype=torch.int32)
    jpos = jnp.asarray([PROMPT], jnp.int32)
    tpos = torch.tensor([PROMPT], dtype=torch.int32)
    jcfg, tcfg = pair["jmodel"].cfg, pair["tmodel"].cfg
    for i in range(upto + 1):
        jh, jsl = jfns[i](pair["jparams"], jh,
                          jax_staging.slice_cache(jcfg, jdonor, i, N_STAGES),
                          jpos)
        th, tsl = tfns[i](pair["tparams"], th,
                          staging.slice_cache(tcfg, tdonor, i, N_STAGES),
                          tpos)
    assert_tree_close(th, jh)
    assert_tree_close(tsl, jax.device_get(jsl))


def test_stage_boundaries_match_reference():
    for n_layers, n_stages in [(30, 4), (4, 4), (2, 4), (7, 3)]:
        assert (staging.stage_boundaries(n_layers, n_stages)
                == jax_staging.stage_boundaries(n_layers, n_stages))


def test_int8_cache_and_other_families_raise():
    """Every family is ported: the int8 cache and each formerly refused
    feature (encdec, Q8.4; MLA attention, Q8.3; gemma2's local/global
    alternation, Q8.6) builds and decodes one step on the CPU; an unknown
    family raises ValueError, as the reference's ``init_lm`` does."""
    cfg = get_reduced("smollm-135m")
    build_model(cfg.replace(kv_cache_dtype="int8"),
                device="cpu").init_cache(1, 4)
    tok = torch.zeros((1, 3), dtype=torch.int64)
    for arch in ("whisper-tiny", "deepseek-v2-236b", "gemma2-27b"):
        m = build_model(get_reduced(arch), device="cpu")
        params = m.init_params(0)
        batch = {"tokens": tok, "cache": m.init_cache(1, 4)}
        if m.cfg.family == "encdec":
            batch["frames"] = torch.zeros((1, m.cfg.encoder_frames,
                                           m.cfg.d_model))
        _, cache = m.prefill(params, batch)
        step = {"tokens": tok[:, :1], "cache": cache}
        if m.cfg.family == "encdec":
            step["enc_out"] = m.encode(params, batch["frames"])
        logits, _ = m.decode_step(params, step)
        assert logits.shape == (1, 1, m.cfg.vocab_size)
        assert torch.isfinite(logits).all()
    bad = build_model(cfg.replace(family="rnn"), device="cpu")
    with pytest.raises(ValueError, match="rnn"):
        bad.init_params(0)
    with pytest.raises(ValueError, match="rnn"):
        bad.init_cache(1, 4)
