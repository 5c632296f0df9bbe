"""The port's int8 KV cache against the JAX package, on the CPU.

* The twin of tests/test_model_equivalences.py's quantization-error test
  (per-token, per-head scales: error under 2% of the largest value).
* ``update_kv_cache`` / ``read_kv_cache`` fed the same numpy k/v as the
  reference's: a prefill block, a decode token after it, and a ring write
  of more tokens than the buffer holds. Both sides compute the scale
  (absmax / 127 in f32) and the codes (round half to even) with the same
  IEEE operations, so the codes must be equal and the scales within 1 ulp
  (they come out equal); the dequantized k/v then agree within 1e-6.
* Reduced qwen1.5-32b (f32 weights, 4 layers so that each of 4 stages owns
  one) with ``kv_cache_dtype="int8"`` and the reference's parameters
  carried over by ``params_from_jax``: prefill and decode logits and caches,
  and the 4 stage functions. The f32 projections round differently in the
  two frameworks (rtol = atol = 1e-4 on logits and scales, as in
  tests/test_torch_model.py), which can move a code that sits within about
  1e-5 of a rounding boundary by one: codes may differ by at most 1, in at
  most ``MAX_OFF_BY_ONE`` places a cache; the count is printed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as jax_get_reduced  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.serving import staging as jax_staging  # noqa: E402

from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import build_model, params_from_jax  # noqa: E402
from repro_torch.serving import staging  # noqa: E402
from test_torch_model import _np  # noqa: E402

ARCH = "qwen1.5-32b"
TOL = dict(rtol=1e-4, atol=1e-4)
N_LAYERS, N_STAGES, BATCH, PROMPT = 4, 4, 2, 8
MAX_OFF_BY_ONE = 2       # codes one apart a cache, of 4 x 2 x 9 x 4 x 16 x 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_cache_close(ours, ref, path="", **tol):
    """Trees equal in keys and shapes; int8 codes at most 1 apart in at
    most ``MAX_OFF_BY_ONE`` places, other integers equal, floats within
    ``tol``. Returns the number of codes 1 apart."""
    if isinstance(ref, dict):
        assert set(ours) == set(ref), (path, set(ours), set(ref))
        return sum(assert_cache_close(ours[k], ref[k], f"{path}/{k}", **tol)
                   for k in ref)
    a, b = _np(ours), _np(ref)
    assert a.shape == b.shape and a.dtype == b.dtype, (path, a.shape, b.shape,
                                                       a.dtype, b.dtype)
    if b.dtype == np.int8:
        diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
        assert diff.max(initial=0) <= 1, path
        off = int(np.count_nonzero(diff))
        assert off <= MAX_OFF_BY_ONE, (path, off)
        return off
    if np.issubdtype(b.dtype, np.integer):
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        np.testing.assert_allclose(a, b, err_msg=path, **(tol or TOL))
    return 0


def test_int8_kv_cache_quantization_error_bounded():
    """Twin of tests/test_model_equivalences.py's test: per-(token, head)
    scales give a relative error of about 1/254."""
    rng = np.random.default_rng(0)
    k = torch.from_numpy(rng.standard_normal((2, 16, 2, 8)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 16, 2, 8)).astype(np.float32))
    cache = attn.make_kv_cache(2, 16, 2, 8, torch.int8)
    cache = attn.update_kv_cache(cache, k, v,
                                 torch.zeros((), dtype=torch.int32))
    kd, vd, _ = attn.read_kv_cache(cache, torch.float32)
    assert float((kd - k).abs().max()) < float(k.abs().max()) * 0.02
    assert float((vd - v).abs().max()) < float(v.abs().max()) * 0.02


def _writes(rng):
    """(name, cache max_len, [(k, v, start), ...]) write sequences."""
    def kv(s):
        return tuple((rng.standard_normal((2, s, 3, 16)) * rng.uniform(
            0.1, 4.0, (2, s, 3, 1))).astype(np.float32) for _ in range(2))
    return [("prefill_then_decode", 12, [(*kv(10), 0), (*kv(1), 10)]),
            ("ring_tail", 8, [(*kv(13), 0), (*kv(1), 13)])]


@pytest.mark.parametrize("case", range(2), ids=["prefill_then_decode",
                                                "ring_tail"])
def test_update_and_read_match_the_reference(case):
    _, t, writes = _writes(np.random.default_rng(7))[case]
    ours = attn.make_kv_cache(2, t, 3, 16, torch.int8)
    ref = jax_attn.make_kv_cache(2, t, 3, 16, "int8")
    assert set(ours) == set(ref) == {"length", "slots_pos", "k", "v",
                                     "k_scale", "v_scale"}
    for k, v, start in writes:
        ours = attn.update_kv_cache(ours, torch.from_numpy(k),
                                    torch.from_numpy(v),
                                    torch.tensor(start, dtype=torch.int32))
        ref = jax_attn.update_kv_cache(ref, jnp.asarray(k), jnp.asarray(v),
                                       jnp.asarray(start, jnp.int32))
        for name in ("k", "v", "slots_pos", "length"):
            np.testing.assert_array_equal(_np(ours[name]), np.asarray(
                ref[name]), err_msg=name)
        for name in ("k_scale", "v_scale"):
            np.testing.assert_array_max_ulp(_np(ours[name]),
                                            np.asarray(ref[name]), maxulp=1)
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        kd, vd, pos = attn.read_kv_cache(ours, dt)
        jk, jv, jpos = jax_attn.read_kv_cache(ref, jdt)
        assert kd.dtype == dt
        np.testing.assert_allclose(_np(kd.float()), _np(jk).astype(np.float32),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(_np(vd.float()), _np(jv).astype(np.float32),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(_np(pos), np.asarray(jpos))


def test_quant_rounds_half_to_even_without_clamp():
    """Codes of values at exact halves of the scale round to even, as
    ``jnp.round`` does; the row's absmax maps to +-127."""
    x = torch.tensor([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -127.0, 3.0]])
    q, scale = attn._quant(x)
    assert float(scale[0]) == 1.0
    assert q.tolist() == [[127, 0, 2, 2, 0, -2, -127, 3]]
    jq, jscale = jax_attn._quant(jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    # an all-zero row: the scale floors at 1e-8 and every code is 0
    q0, s0 = attn._quant(torch.zeros(1, 4))
    assert q0.abs().max() == 0 and float(s0[0]) == pytest.approx(1e-8)


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_get_reduced(ARCH).replace(n_layers=N_LAYERS,
                                         kv_cache_dtype="int8")
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init_params(0)
    tmodel = build_model(get_reduced(ARCH).replace(
        n_layers=N_LAYERS, kv_cache_dtype="int8"), device="cpu")
    tparams = params_from_jax(jax.device_get(jparams), device="cpu")
    tokens = np.random.default_rng(3).integers(0, jcfg.vocab_size,
                                               (BATCH, PROMPT + 1))
    jlogits, jdonor = jmodel.prefill(
        jparams, {"tokens": jnp.asarray(tokens[:, :PROMPT]),
                  "cache": jmodel.init_cache(BATCH, PROMPT + 1)})
    return dict(jmodel=jmodel, jparams=jparams, tmodel=tmodel,
                tparams=tparams, tokens=tokens, jlogits=jlogits,
                jdonor=jax.device_get(jdonor))


def test_cache_tree_and_bytes(pair):
    """The int8 cache holds codes and f32 scales; at Dh 128 it takes
    (1 + 4/128) / 2 = 0.516 of a bf16 cache's bytes."""
    cache = pair["tmodel"].init_cache(BATCH, PROMPT + 1)
    assert_cache_close(cache, jax.device_get(
        pair["jmodel"].init_cache(BATCH, PROMPT + 1)))
    cfg = get_config(ARCH)
    assert cfg.kv_cache_dtype == "int8" and cfg.resolved_head_dim == 128
    full = build_model(cfg.replace(n_layers=1), device="cpu")
    i8 = full.init_cache(1, 4)
    bf = build_model(cfg.replace(n_layers=1, kv_cache_dtype="bfloat16"),
                     device="cpu").init_cache(1, 4)

    def kv_bytes(c):
        return sum(t.numel() * t.element_size() for k, t in c.items()
                   if k not in ("length", "slots_pos"))
    assert kv_bytes(i8) / kv_bytes(bf) == pytest.approx((1 + 4 / 128) / 2)


def test_prefill_logits_and_cache(pair):
    tm = pair["tmodel"]
    logits, cache = tm.prefill(
        pair["tparams"], {"tokens": torch.from_numpy(
            pair["tokens"][:, :PROMPT]),
            "cache": tm.init_cache(BATCH, PROMPT + 1)})
    np.testing.assert_allclose(_np(logits), np.asarray(pair["jlogits"]),
                               **TOL)
    off = assert_cache_close(cache, pair["jdonor"])
    print(f"prefill cache: {off} codes one apart")


def test_decode_step_logits_and_cache(pair):
    jm, tm = pair["jmodel"], pair["tmodel"]
    tok = pair["tokens"][:, PROMPT:]
    jl, jc = jm.decode_step(pair["jparams"],
                            {"tokens": jnp.asarray(tok),
                             "cache": jax.tree.map(jnp.asarray,
                                                   pair["jdonor"])})
    donor = params_from_jax(pair["jdonor"], device="cpu")
    tl, tc = tm.decode_step(pair["tparams"],
                            {"tokens": torch.from_numpy(tok), "cache": donor})
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    off = assert_cache_close(tc, jax.device_get(jc))
    print(f"decode cache: {off} codes one apart")
    # functional update: the donor the step read is untouched
    assert_cache_close(donor, pair["jdonor"], rtol=0, atol=0)


@pytest.mark.parametrize("upto", range(N_STAGES))
def test_stage_functions_match_reference(pair, upto):
    """Stages 0..upto chained in both packages from the same donor: each
    stage's output (logits for the last) and updated int8 cache slice."""
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
    np.testing.assert_allclose(_np(th), np.asarray(jh), **TOL)
    assert_cache_close(tsl, jax.device_get(jsl))
