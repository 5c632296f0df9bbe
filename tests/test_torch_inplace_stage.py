"""The staged LM decode with its caches written in place and its rope tables
built once a stage, on the CPU.

A stage program's stage function (``make_lm_stage_fns(..., in_place=True)``)
writes each layer's new slots, or its new SSM state, conv histories and
``length``, into the cache slice it was given, which is the program's own
static copy: the counterpart of XLA writing the reference's scan output in
place. Every other caller keeps the functional update.

- For each served LM family (dense smollm-135m, with a bf16 and an int8
  cache; ssm mamba2-2.7b; moe qwen2-moe-a2.7b; mla deepseek-v2; gemma2, its
  prompt past the reduced window so the local ring wraps), reduced, three
  jobs through the in-place stage chain equal the functional chain bit for
  bit: hidden states, logits and cache slices, called directly on copies
  of the donor's slices and through the served payloads' stage programs;
  the donor cache's bytes stay as they were.
- ``run_layers`` builds the rope tables once for every layer: its output
  and cache equal a loop of layers that each build their own, bit for bit.
- ``rope_tables`` then ``rope_apply`` equal the parent's ``apply_rope``
  (copied here as ``_apply_rope_before``) bit for bit, in f32 and bf16,
  for one position row and for a row a sequence; and MLA's rope heads
  with ``mla_rope``'s tables equal the same application.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import api  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.models import (build_model, layers, mla,  # noqa: E402
                                transformer)
from repro_torch.serving.engine import staged_lm_taskspec  # noqa: E402
from repro_torch.serving.staging import (make_lm_stage_fns,  # noqa: E402
                                         slice_cache)

N_STAGES, BATCH = 4, 2
FAMILIES = {
    "dense": ("smollm-135m", dict(n_layers=4)),
    "int8_cache": ("smollm-135m", dict(n_layers=4, kv_cache_dtype="int8")),
    "ssm": ("mamba2-2.7b", dict(n_layers=4)),
    "moe": ("qwen2-moe-a2.7b", dict(n_layers=4)),
    "mla": ("deepseek-v2-236b", dict(n_layers=5)),
    "gemma2": ("gemma2-27b", dict(n_layers=8)),
}
PROMPT = 20                      # past gemma2's reduced window of 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _model(family):
    arch, replace = FAMILIES[family]
    model = build_model(get_reduced(arch).replace(**replace), device="cpu")
    return model, model.init_params(0)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return tree.clone()


def _same(a, b) -> bool:
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _donor(model, params):
    cfg = model.cfg
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (BATCH, PROMPT)))
    _, donor = model.prefill(params, {
        "tokens": tokens, "cache": model.init_cache(BATCH, PROMPT + 1)})
    return donor


def _job_tokens(cfg, job):
    return torch.from_numpy(np.random.default_rng(10 + job).integers(
        0, cfg.vocab_size, (BATCH, 1))).to(torch.int32)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_in_place_stage_fns_equal_the_functional_ones_bit_for_bit(family):
    model, params = _model(family)
    cfg = model.cfg
    donor = _donor(model, params)
    kept = _clone(donor)
    pos = torch.tensor([PROMPT], dtype=torch.int32)
    in_place = make_lm_stage_fns(model, N_STAGES, in_place=True)
    functional = make_lm_stage_fns(model, N_STAGES)
    for job in range(3):
        h = hf = _job_tokens(cfg, job)
        for i in range(N_STAGES):
            sl = slice_cache(cfg, donor, i, N_STAGES)
            hf, want = functional[i](params, hf, sl, pos)
            mine = _clone(sl)
            h, got = in_place[i](params, h, mine, pos)
            assert got is mine                  # the slice it was given
            assert torch.equal(h, hf) and _same(got, want)
        assert h.shape == (BATCH, 1, cfg.vocab_size)
        assert torch.isfinite(h.float()).all()
    assert _same(donor, kept)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_served_in_place_payloads_equal_the_functional_stages(family):
    """Through ``staged_lm_taskspec``'s payloads (each a stage program whose
    function writes its static copy in place): three jobs, each stage
    held to the program's ``functional`` on the same state; each job's
    cache slices differ from the donor's where the step wrote them, and
    the donor's bytes are as they were."""
    model, params = _model(family)
    cfg = model.cfg
    spec = staged_lm_taskspec(model, priority=api.HP, jps=10.0,
                              n_stages=N_STAGES, prompt_len=PROMPT,
                              batch=BATCH, device="cpu", params=params)
    donors = [st.payload.keywords["donor_slice"] for st in spec.stages]
    kept = [_clone(d) for d in donors]
    for job in range(3):
        state = {"hidden": _job_tokens(cfg, job), "slices": {}}
        for st in spec.stages:
            prog = st.payload.keywords["program"]
            ref = functools.partial(st.payload.func, **{
                **st.payload.keywords, "program": prog.functional})(state)
            out = st.payload(state)
            assert _same(out, ref)
            state = out
        assert state["hidden"].shape == (BATCH, 1, cfg.vocab_size)
        written = [i for i, d in enumerate(donors) if _leaves(d)
                   and not _same(state["slices"][i], d)]
        assert written               # the step wrote the job's own slices
    assert all(_same(d, k) for d, k in zip(donors, kept))


@pytest.mark.parametrize("family", ["dense", "moe", "mla", "gemma2"])
@pytest.mark.parametrize("with_cache", [True, False],
                         ids=["decode", "prefill"])
def test_run_layers_rope_once_equals_rope_in_every_layer(family,
                                                         with_cache):
    model, params = _model(family)
    cfg = model.cfg
    if with_cache:
        cache = _donor(model, params)
        if cfg.family == "moe":
            cache = cache["layers"]
        pos = torch.tensor([PROMPT], dtype=torch.int32)
        s = 1
    else:
        cache, pos, s = None, torch.arange(PROMPT, dtype=torch.int32), PROMPT
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (BATCH, s, cfg.d_model)).astype(np.float32)).to(params["embed"].dtype)
    got, got_cache, _ = transformer.run_layers(
        params["layers"], x, cfg, pos, cache, moe_oracle=True)
    want = x
    caches = []
    n = transformer._first_leaf(params["layers"]).shape[0]
    for li in range(n):
        ca = None if cache is None else transformer.index_tree(cache, li)
        want, nc, _ = transformer.layer_body(
            transformer.index_tree(params["layers"], li), want, cfg, pos, ca,
            True)                             # rope=None: built per layer
        caches.append(nc)
    assert torch.equal(got, want)
    if with_cache:
        assert _same(got_cache, transformer.stack_trees(caches))


def _apply_rope_before(x, positions, theta):
    """``layers.apply_rope`` as the parent tree had it, one function."""
    dh = x.shape[-1]
    freqs = layers.rope_freqs(dh, theta, x.device)
    ang = positions[..., :, None].float() * freqs
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("batched_positions", [False, True],
                         ids=["positions_S", "positions_BS"])
def test_rope_tables_then_apply_equal_the_previous_apply_rope(
        dtype, batched_positions):
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((3, 7, 4, 32)).astype(
        np.float32)).to(dtype)
    pos = torch.from_numpy(rng.integers(0, 5000, (3, 7) if batched_positions
                                        else (7,))).to(torch.int32)
    for theta in (10000.0, 1e6):
        want = _apply_rope_before(x, pos, theta)
        tables = layers.rope_tables(pos, 32, theta)
        assert torch.equal(layers.rope_apply(x, *tables), want)
        assert torch.equal(layers.apply_rope(x, pos, theta), want)
        # one set of tables serves every head width's layer of that width
        assert torch.equal(layers.rope_apply(x[:, :, :1], *tables),
                           want[:, :, :1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_mla_rope_heads_take_the_shared_tables(dtype):
    """MLA's query and key rope heads (``qk_rope_head_dim`` wide) with
    ``mla_rope``'s tables equal the previous per-call application, and the
    block's output and latent cache with given tables equal the block
    building its own."""
    model, params = _model("mla")
    cfg = model.cfg
    lp = {k: v.to(dtype) for k, v in transformer.index_tree(
        params["layers"]["attn"], 0).items()}
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((BATCH, 5, cfg.d_model)).astype(
        np.float32)).to(dtype)
    pos = torch.arange(5, dtype=torch.int32) + 9
    tables = mla.mla_rope(cfg, pos)
    nope = cfg.qk_nope_head_dim
    _, q_rope = mla._project_q(lp, x, cfg, tables)
    q = (layers.rms_norm(x @ lp["q_down"], lp["q_norm"])
         @ lp["q_up"].reshape(lp["q_up"].shape[0], -1)).view(
             BATCH, 5, cfg.n_heads, -1)
    assert torch.equal(q_rope, _apply_rope_before(q[..., nope:], pos,
                                                  cfg.rope_theta))
    _, k_rope = mla._project_latent(lp, x, cfg, tables)
    ckv = x @ lp["kv_down"]
    assert torch.equal(k_rope, _apply_rope_before(
        ckv[..., None, cfg.kv_lora_rank:], pos, cfg.rope_theta)[..., 0, :])
    cache = mla.make_mla_cache(BATCH, 8, cfg, dtype)
    y0, c0 = mla.mla_block(lp, x, cfg=cfg, positions=pos, cache=cache)
    y1, c1 = mla.mla_block(lp, x, cfg=cfg, positions=pos, cache=cache,
                           rope=tables)
    assert torch.equal(y0, y1) and _same(c0, c1)
