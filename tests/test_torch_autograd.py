"""The kernel wrappers under autograd, on the CPU.

On the card each wrapper writes its kernel's result into a fresh tensor
that autograd cannot see; under autograd it therefore goes through a
``torch.autograd.Function`` whose forward is the wrapper's and whose
backward recomputes the plain version (the reference has no backward
kernel). Here:

* ``gradcheck`` in f64 on each Function through its CPU path: RMSNorm with
  and without ``plus_one``, the fused residual norm, flash attention with
  GQA, softcap, window, ``q_chunk`` and keys of their own length, the SSD
  scan with and without an initial state;
* the routing: with the forward replaced by one whose result is cut from
  the graph (as a kernel's is), the public wrappers still give the plain
  version's gradients, and count one backward recompute a call; without
  grad they keep their plain path and count no recompute;
* on bf16 inputs the norms' and flash's gradients (flash's also in
  query blocks) are an f32 gradient rounded once to bf16;
* decode attention raises under grad on a non-CPU input;
* every remat mode and a ``q_chunk`` give the loss and gradients of
  ``"none"`` (f32 on the CPU; remat reruns the same operations, and the
  query blocks of ``q_chunk`` only sum the key and value gradients in
  another order: within 1e-5 of the largest gradient of any leaf, since
  some leaves' true gradient is 0, e.g. a key bias, and theirs is
  rounding noise), and
  ``"dots"`` keeps the weight products' outputs (no ``mm`` recomputed)
  where ``"full"`` recomputes them.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch.autograd import gradcheck  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.kernels import decode_attention as dec  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import rmsnorm as rms  # noqa: E402
from repro_torch.kernels import ssd_scan  # noqa: E402
from repro_torch.models import build_model, transformer  # noqa: E402
from repro_torch.training.optimizer import tree_leaves  # noqa: E402
from repro_torch.training.train_step import (make_loss_fn,  # noqa: E402
                                             value_and_grad)

F64 = torch.float64
REMAT_TOL = 1e-5      # of the largest gradient: sums in another order


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaf(gen, *shape, scale=1.0):
    return (torch.randn(shape, generator=gen, dtype=F64) * scale
            ).requires_grad_()


@pytest.mark.parametrize("plus_one", [False, True])
def test_rmsnorm_function_gradcheck(plus_one):
    g = torch.Generator().manual_seed(0)
    x, r, w = _leaf(g, 3, 5, 8), _leaf(g, 3, 5, 8), _leaf(g, 8)
    assert gradcheck(lambda a, c: rms.rmsnorm(a, c, plus_one=plus_one),
                     (x, w))
    assert gradcheck(lambda a, b, c: rms.rmsnorm_residual(
        a, b, c, plus_one=plus_one), (x, r, w))


@pytest.mark.parametrize("kw,s_kv", [
    ({}, None),                                       # causal, GQA 2:1
    ({"softcap": 2.0, "window": 3}, None),
    ({"q_chunk": 4, "window": 5}, None),              # two query blocks
    ({"causal": False}, 5),                           # keys of their own
    ({"causal": False, "softcap": 1.5, "q_chunk": 4}, 11),
], ids=["causal", "softcap-window", "q_chunk", "skv", "skv-softcap-chunk"])
def test_flash_attention_function_gradcheck(kw, s_kv):
    g = torch.Generator().manual_seed(1)
    s = 8
    q = _leaf(g, 2, 4, s, 6)
    k, v = _leaf(g, 2, 2, s_kv or s, 6), _leaf(g, 2, 2, s_kv or s, 6)
    assert gradcheck(lambda a, b, c: fa.flash_attention(a, b, c, **kw),
                     (q, k, v))


BF16_ROUNDING = 2.0 ** -8        # round to nearest, 8 significant bits


@pytest.mark.parametrize("case", ["rmsnorm", "rmsnorm_residual", "flash",
                                  "flash_q_chunk"])
def test_bf16_gradients_are_rounded_once(case):
    """On bf16 inputs each Function computes its gradients in f32 and
    rounds them to bf16 once: against autograd of the plain version in
    f64 on the same values, within 2^-8 of each input's largest gradient
    (and f32's share, 1e-5). Flash's query blocks (``q_chunk``) sum the
    key and value gradients in f32 before that rounding."""
    g = torch.Generator().manual_seed(5)

    def leaf(*shape):
        return torch.randn(shape, generator=g).to(
            torch.bfloat16).requires_grad_()
    if case.startswith("flash"):
        inputs = (leaf(2, 4, 64, 16), leaf(2, 2, 64, 16), leaf(2, 2, 64, 16))
        q_chunk = 16 if case == "flash_q_chunk" else 0

        def call(*t):
            return fa.flash_attention(*t, q_chunk=q_chunk)
        plain = fa.flash_attention_plain
    elif case == "rmsnorm":
        inputs, call, plain = ((leaf(32, 24), leaf(24)), rms.rmsnorm,
                               rms.rmsnorm_plain)
    else:
        inputs, call, plain = ((leaf(32, 24), leaf(32, 24), leaf(24)),
                               rms.rmsnorm_residual,
                               rms.rmsnorm_residual_plain)
    outs = _tuple(call(*inputs))
    cots = [torch.randn(o.shape, generator=g).to(o.dtype) for o in outs]
    got = torch.autograd.grad(outs, inputs, cots)
    wide = [t.detach().double().requires_grad_() for t in inputs]
    want = torch.autograd.grad(_tuple(plain(*wide)), wide,
                               [c.double() for c in cots])
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        err = float((a.double() - b).abs().max() / b.abs().max())
        assert err <= BF16_ROUNDING + 1e-5, (case, err)


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_function_gradcheck(with_state):
    g = torch.Generator().manual_seed(2)
    b, ln, h, p, gr, n = 2, 8, 4, 3, 2, 5
    x = _leaf(g, b, ln, h, p)
    dt = (torch.rand((b, ln, h), generator=g, dtype=F64) * 0.5
          + 0.1).requires_grad_()
    a_log = _leaf(g, h, scale=0.5)
    bm, cm = _leaf(g, b, ln, gr, n), _leaf(g, b, ln, gr, n)
    inputs = (x, dt, a_log, bm, cm)
    if with_state:
        inputs += (_leaf(g, b, h, p, n),)
    assert gradcheck(lambda *t: ssd_scan.ssd(*t[:5], 4, *t[5:]), inputs)


def _cut(fn):
    """``fn``'s result computed out of autograd's sight: what a kernel's
    fresh output tensor is."""
    def forward(*args):
        with torch.no_grad():
            return fn(*args)
    return forward


CASES = {
    "rmsnorm": (rms, lambda g: (_leaf(g, 4, 6), _leaf(g, 6)),
                lambda m, *t: m.rmsnorm(*t),
                lambda *t: rms.rmsnorm_plain(*t)),
    "rmsnorm_residual": (rms, lambda g: (_leaf(g, 4, 6), _leaf(g, 4, 6),
                                         _leaf(g, 6)),
                         lambda m, *t: m.rmsnorm_residual(*t),
                         lambda *t: rms.rmsnorm_residual_plain(*t)),
    "flash_attention": (fa, lambda g: (_leaf(g, 1, 4, 6, 8),
                                       _leaf(g, 1, 2, 6, 8),
                                       _leaf(g, 1, 2, 6, 8)),
                        lambda m, *t: m.flash_attention(*t, softcap=3.0),
                        lambda *t: fa.flash_attention_plain(*t, softcap=3.0)),
    "ssd": (ssd_scan, lambda g: (_leaf(g, 1, 8, 2, 3), _leaf(g, 1, 8, 2),
                                 _leaf(g, 2), _leaf(g, 1, 8, 1, 4),
                                 _leaf(g, 1, 8, 1, 4)),
            lambda m, *t: m.ssd(*t, 4), lambda *t: ssd_scan.ssd_plain(*t, 4)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_wrappers_keep_the_graph_when_the_forward_is_cut(monkeypatch, name):
    """With the forward replaced by one whose result autograd cannot see
    (as a kernel's fresh output tensor), the public wrapper still yields
    the plain version's gradients, with one backward recompute counted a
    call; the forward alone gives no graph."""
    mod, make, call, plain = CASES[name]
    inputs = make(torch.Generator().manual_seed(3))
    monkeypatch.setattr(mod, "_forward", _cut(mod._forward))
    cut = mod._forward(*inputs[:1], *_forward_args(name, inputs))
    assert all(o.grad_fn is None for o in _tuple(cut))
    counts = getattr(mod, name).counts
    counts.reset()
    outs = _tuple(call(mod, *inputs))
    assert all(o.grad_fn is not None for o in outs)
    cots = [torch.ones_like(o) for o in outs]
    got = torch.autograd.grad(outs, inputs, cots)
    want = torch.autograd.grad(_tuple(plain(*inputs)), inputs, cots)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert counts.backward == 1 and len(counts.backward_by_shape) == 1
    assert counts.plain_cuda_calls == 0


def _forward_args(name, inputs):
    """The rest of ``_forward``'s positional arguments for ``inputs``."""
    if name == "rmsnorm":
        return (None, inputs[1], 1e-6, False)
    if name == "rmsnorm_residual":
        return (inputs[1], inputs[2], 1e-6, False)
    if name == "flash_attention":
        return (*inputs[1:], True, 0, 3.0, None, 0)
    return (*inputs[1:], 4, None)


def _tuple(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("name", sorted(CASES))
def test_wrappers_take_their_plain_path_without_grad(name):
    mod, make, call, plain = CASES[name]
    inputs = make(torch.Generator().manual_seed(4))
    counts = getattr(mod, name).counts
    counts.reset()
    with torch.no_grad():
        outs = _tuple(call(mod, *inputs))
    assert all(o.grad_fn is None for o in outs)
    assert counts.backward == 0 and counts.plain_calls == 1
    detached = [t.detach() for t in inputs]   # no input needs grad
    outs = _tuple(call(mod, *detached))
    assert all(o.grad_fn is None for o in outs)
    assert counts.backward == 0 and counts.plain_calls == 2


def test_decode_attention_raises_under_grad_off_the_cpu():
    """No path trains through decode: on an input off the CPU (here the
    meta device, where the kernel path starts) that autograd would record,
    the wrapper raises instead of returning a result cut from the graph;
    on the CPU it takes the plain version and keeps the graph. Without
    grad a meta input gets its output's shape from the operator's fake
    kernel (the dry-run's use): no launch, no plain call."""
    q = torch.zeros((2, 4, 8), device="meta", requires_grad=True)
    k = torch.zeros((2, 2, 5, 8), device="meta")
    pos = torch.zeros(5, dtype=torch.int32, device="meta")
    qp = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="no backward"):
        dec.decode_attention(q, k, k, pos, qp)
    dec.decode_attention.counts.reset()
    with torch.no_grad():
        out = dec.decode_attention(q, k, k, pos, qp)
    assert out.device.type == "meta" and out.shape == q.shape
    assert dec.decode_attention.counts.plain_calls == 0
    qc = torch.randn((2, 4, 8), requires_grad=True)
    out = dec.decode_attention(qc, torch.randn(2, 2, 5, 8),
                               torch.randn(2, 2, 5, 8),
                               torch.arange(5, dtype=torch.int32),
                               torch.full((2,), 4, dtype=torch.int32))
    assert out.grad_fn is not None


def _batch(cfg, b=2, s=16, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     (b, s)))}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.encoder_frames, cfg.d_model)).astype(np.float32))
    if cfg.family == "vlm":
        batch["image_embeds"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.n_image_tokens, cfg.d_model)).astype(np.float32))
    return batch


@pytest.mark.parametrize("arch", ["smollm-135m", "gemma2-27b", "mamba2-2.7b",
                                  "zamba2-7b", "deepseek-v2-236b",
                                  "whisper-tiny", "pixtral-12b"])
def test_remat_and_q_chunk_change_nothing(arch):
    cfg = get_reduced(arch)
    model = build_model(cfg, device="cpu")
    params = model.init_params(0)
    # 17 tokens: whisper's decoder sees 16, which a q_chunk of 8 divides
    batch = _batch(cfg, s=16 if cfg.family != "encdec" else 17)
    ref_loss, ref_g = value_and_grad(make_loss_fn(model, remat="none"),
                                     params, batch)
    ref_g = tree_leaves(ref_g)
    top = max(float(g.abs().max()) for g in ref_g)
    for remat, q_chunk in (("full", 0), ("dots", 0), ("none", 8),
                           ("dots", 8)):
        loss, grads = value_and_grad(
            make_loss_fn(model, q_chunk=q_chunk, remat=remat), params, batch)
        assert abs(float(loss - ref_loss)) <= REMAT_TOL * float(ref_loss)
        for a, b in zip(tree_leaves(grads), ref_g):
            assert float((a - b).abs().max()) <= REMAT_TOL * top, (
                remat, q_chunk)


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[func] = self.n.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def test_dots_keeps_the_weight_products_and_full_recomputes_them():
    cfg = get_reduced("smollm-135m")
    model = build_model(cfg, device="cpu")
    params = model.init_params(0)
    batch = _batch(cfg)
    mm, norms = {}, {}
    for remat in transformer.REMAT_MODES:
        ops = _CountOps()
        with ops:
            value_and_grad(make_loss_fn(model, remat=remat), params, batch)
        mm[remat] = ops.n.get(torch.ops.aten.mm.default, 0)
        # a norm runs as its operator (forward, remat's recompute) or as
        # the plain version's aten ops (the Function's backward)
        norms[remat] = sum(ops.n.get(op, 0) for op in (
            torch.ops.aten.rsqrt.default,
            torch.ops.repro_torch.rmsnorm.default,
            torch.ops.repro_torch.rmsnorm_residual.default))
    assert mm["dots"] == mm["none"] < mm["full"]
    # both remat modes run each layer's norms again in the backward
    assert norms["none"] < norms["dots"] == norms["full"]
    with pytest.raises(ValueError, match="remat"):
        value_and_grad(make_loss_fn(model, remat="everything"), params,
                       batch)
