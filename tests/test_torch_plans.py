"""The choices the RMSNorm and SSD wrappers make before they launch, on the
CPU, and the SSD tensor-core instance's arithmetic.

- ``rmsnorm_plan`` (threads a row, rows a CTA, vectors a thread, vector
  width) for every (M, D, dtype) the paths use, odd widths and misaligned
  views: each plan covers its row with one CTA of at most 256 threads (or
  a warp), takes the scalar instance where 16-byte vectors are illegal,
  and ``plan_cover`` (the kernel's index arithmetic, written out) reaches
  every element of every row exactly once.
- ``ssd_instance`` picks the instance the design names for the shapes of
  tests/test_torch_cuda.py and the reduced and full mamba2-2.7b configs.
- ``ssd_tensor_core_emulation`` does on the CPU, in f32, what the two
  tensor-core SSD kernels do on the card, with their roundings to bf16
  (C B^T rounded; W, the scaled X and the state split into a bf16 high
  part and residual); it is held to the JAX package's reference
  (``ops.ssd(mode="ref")``, bf16 inputs, through numpy) and to the port's
  plain version, at the bf16 tolerance 3e-2 of tests/test_kernels.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops  # noqa: E402

from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.kernels import rmsnorm as rms  # noqa: E402
from repro_torch.kernels import ssd_scan  # noqa: E402

PATH_ROWS = (4, 2048)            # decode batch, prefill (4 x 512 tokens)
PATH_WIDTHS = (576, 2560, 5120)  # smollm d_model; mamba2 d_model, d_inner
DTYPES = (torch.bfloat16, torch.float32)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def plan_cover(plan, m, d):
    """How many times the kernel touches each element of [m, d]: CTA
    ``blk`` of the grid holds rows blk * rows_per_cta + tid // tpr; its
    thread reads vectors tid % tpr + k * tpr, k < vpt, of those below d /
    vec (csrc/rmsnorm.cu, rmsnorm_kernel)."""
    hits = np.zeros((m, d), np.int64)
    nvec = d // plan.vec
    for blk in range(plan.grid(m)):
        for tid in range(plan.threads):
            row = blk * plan.rows_per_cta + tid // plan.tpr
            if row >= m:
                continue
            for k in range(plan.vpt):
                i = tid % plan.tpr + k * plan.tpr
                if i < nvec:
                    hits[row, i * plan.vec:(i + 1) * plan.vec] += 1
    return hits


def _check_plan(plan, m, d):
    assert plan.tpr % 32 == 0 and plan.threads <= rms.MAX_THREADS
    assert plan.vpt in (rms.VPT_CHOICES if plan.vec > 1
                        else rms.SCALAR_VPT_CHOICES)
    assert plan.rows_per_cta == 1 or plan.tpr == 32
    assert plan.tpr * plan.vpt * plan.vec >= d
    # no slack a smaller plan would not have: one warp fewer would leave
    # part of the row uncovered
    if plan.tpr > 32:
        assert (plan.tpr - 32) * plan.vpt * plan.vec < d
    assert plan.threads * plan.grid(m) >= m


@pytest.mark.parametrize("m", PATH_ROWS)
@pytest.mark.parametrize("d", PATH_WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_plan_at_the_paths_shapes(m, d, dtype):
    plan = rms.rmsnorm_plan(m, d, dtype)
    _check_plan(plan, m, d)
    assert plan.vec == 16 // torch.empty((), dtype=dtype).element_size()
    if m == 4:      # decode: a CTA a row, the fewest vectors a thread
        assert plan.instance == "block" and plan.rows_per_cta == 1
        want = ({576: 1, 2560: 2, 5120: 4} if dtype == torch.bfloat16
                else {576: 1, 2560: 4, 5120: 8})
        assert plan.vpt == want[d]
    else:           # prefill: a warp a row where it covers the row
        assert plan.instance == ("warp" if d == 576 else "block")
        assert plan.grid(m) * plan.rows_per_cta >= m
    if m * d <= 4 * 5120:
        assert (plan_cover(plan, m, d) == 1).all()


@pytest.mark.parametrize("m,d", [(1, 577), (4, 100), (37, 96), (2048, 100),
                                 (4, 5121), (300, 2563)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_plan_odd_widths_take_the_scalar_instance(m, d, dtype):
    plan = rms.rmsnorm_plan(m, d, dtype)
    _check_plan(plan, m, d)
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    assert (plan.vec == 1) == (d % vec != 0)
    assert plan.instance.endswith("_scalar") == (plan.vec == 1)
    cover = plan_cover(plan, min(m, 40), d)
    assert (cover == 1).all()


@pytest.mark.parametrize("d", PATH_WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_plan_for_misaligned_views(d, dtype):
    """A base off a 16-byte boundary (x, the residual or the weight) takes
    the scalar instance; an aligned one the vectors."""
    big = torch.zeros(4 * d + 8, dtype=dtype)
    w = torch.ones(d, dtype=torch.float32)
    assert rms.plan_for(big[:4 * d].view(4, d), w).vec > 1
    off = big[1:4 * d + 1].view(4, d)
    plan = rms.plan_for(off, w)
    assert plan.vec == 1 and plan.instance.endswith("_scalar")
    # one CTA a row even for the 2560 and 5120 scalars: 16 or 32 a thread
    assert plan.instance == "block_scalar" and plan.rows_per_cta == 1
    assert plan.vpt == {576: 4, 2560: 16, 5120: 32}[d]
    _check_plan(plan, 4, d)
    assert (plan_cover(plan, 4, d) == 1).all()
    assert rms.plan_for(big[:4 * d].view(4, d), w, off).vec == 1
    wo = torch.ones(d + 1, dtype=torch.float32)[1:]
    assert rms.plan_for(big[:4 * d].view(4, d), wo).vec == 1


def test_rmsnorm_plan_refuses_widths_past_its_cover():
    with pytest.raises(ValueError):      # scalar: 256 threads x 32
        rms.rmsnorm_plan(4, 256 * 32 + 1, torch.float32)
    with pytest.raises(ValueError):      # f32 vectors: 256 threads x 8 x 4
        rms.rmsnorm_plan(4, 256 * 8 * 4 + 4, torch.float32)
    assert rms.rmsnorm_plan(4, 256 * 32, torch.float32).vpt == 8


def _ssd_shape_inputs(bs, ln, h, p, g, n, dtype):
    return (torch.zeros((bs, ln, h, p), dtype=dtype),
            torch.zeros((bs, ln, g, n), dtype=dtype))


@pytest.mark.parametrize("shape,dtype,want", [
    # tests/test_torch_cuda.py's shapes (B, L, H, P, G, N, chunk)
    ((2, 128, 4, 16, 1, 16, 32), torch.bfloat16, "cuda_core"),
    ((1, 192, 6, 64, 2, 128, 96), torch.bfloat16, "cuda_core"),
    ((2, 512, 8, 64, 1, 128, 256), torch.bfloat16, "tensor_core"),
    ((2, 512, 8, 64, 1, 128, 256), torch.float32, "cuda_core"),
    ((2, 512, 8, 64, 2, 64, 128), torch.bfloat16, "tensor_core"),
    ((4, 512, 80, 64, 1, 128, 256), torch.bfloat16, "tensor_core"),
    ((4, 512, 80, 64, 1, 128, 256), torch.float32, "cuda_core"),
    ((2, 256, 4, 64, 1, 32, 64), torch.bfloat16, "cuda_core"),
])
def test_ssd_instance_for_the_tested_shapes(shape, dtype, want):
    bs, ln, h, p, g, n, chunk = shape
    x, b = _ssd_shape_inputs(bs, ln, h, p, g, n, dtype)
    assert ssd_scan.ssd_instance(x, b, chunk) == want
    # the kernels its counts name: a state pass and outputs, or one
    assert len(ssd_scan.INSTANCE_KERNELS[want]) == (
        2 if want == "tensor_core" else 1)


@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_ssd_instance_for_the_mamba2_configs(reduced, dtype):
    """The reduced config (P 16, N 16, chunk 8) takes the CUDA-core
    instance in either dtype; the full one (P 64, N 128, chunk 256) the
    tensor cores in bf16, its serving dtype."""
    cfg = (get_reduced if reduced else get_config)("mamba2-2.7b")
    x, b = _ssd_shape_inputs(1, cfg.ssm_chunk, cfg.ssm_nheads,
                             cfg.ssm_headdim, cfg.ssm_ngroups, cfg.ssm_state,
                             getattr(torch, dtype))
    want = ("tensor_core" if not reduced and dtype == "bfloat16"
            else "cuda_core")
    assert ssd_scan.ssd_instance(x, b, cfg.ssm_chunk) == want


def test_ssd_instance_misaligned_base_takes_the_cuda_cores():
    x = torch.zeros(2 * 128 * 2 * 64 + 1, dtype=torch.bfloat16)[1:].view(
        2, 128, 2, 64)
    b = torch.zeros((2, 128, 1, 64), dtype=torch.bfloat16)
    assert ssd_scan.ssd_instance(x, b, 64) == "cuda_core"
    c = torch.zeros(2 * 128 * 64 + 1, dtype=torch.bfloat16)[1:].view(
        2, 128, 1, 64)
    x = torch.zeros((2, 128, 2, 64), dtype=torch.bfloat16)
    assert ssd_scan.ssd_instance(x, b, 64) == "tensor_core"
    assert ssd_scan.ssd_instance(x, b, 64, c) == "cuda_core"


def _hi_lo(t):
    """f32 t as a bf16 high part and a bf16 residual (both as f32)."""
    hi = t.to(torch.bfloat16).float()
    return hi, (t - hi).to(torch.bfloat16).float()


def ssd_tensor_core_emulation(x, dt, a_log, b, c, chunk, init=None):
    """The tensor-core SSD instance's arithmetic in f32 on the CPU: per
    chunk, y_inter = exp(cum_i) C_i . (state_hi + state_lo); S = C B^T
    rounded to bf16; W = S exp(cum_i - cum_j) dt_j for j <= i; y_intra =
    (W_hi + W_lo) X; state <- state exp(cum_Q) + (Xw_hi + Xw_lo)^T B with
    Xw = X exp(cum_Q - cum_j) dt_j. Returns (y in x's dtype, f32 state)."""
    bs, ln, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    rep = h // g
    a = -torch.exp(a_log.float())
    xf, dtf = x.float(), dt.float()
    bf = b.float().repeat_interleave(rep, dim=2)
    cf = c.float().repeat_interleave(rep, dim=2)
    state = None if init is None else init.float()
    ys = []
    for c0 in range(0, ln, chunk):
        sl = slice(c0, c0 + chunk)
        cum = torch.cumsum(dtf[:, sl] * a, dim=1)              # [B, Q, H]
        y = torch.zeros((bs, chunk, h, p))
        if state is not None:
            for part in _hi_lo(state):
                y = y + torch.einsum("bqhn,bhpn->bqhp", cf[:, sl], part)
            y = y * torch.exp(cum)[..., None]
        s = torch.einsum("bqhn,bkhn->bhqk", cf[:, sl], bf[:, sl])
        s = s.to(torch.bfloat16).float()
        ch = cum.movedim(1, 2)                                  # [B, H, Q]
        diff = ch[..., :, None] - ch[..., None, :]
        causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool))
        decay = torch.where(causal, torch.exp(diff.clamp_max(0.0)),
                            torch.zeros(()))
        w = s * decay * dtf[:, sl].movedim(1, 2)[:, :, None, :]
        for part in _hi_lo(w):
            y = y + torch.einsum("bhqk,bkhp->bqhp", part, xf[:, sl])
        ys.append(y)
        wend = torch.exp(cum[:, -1:] - cum) * dtf[:, sl]       # [B, Q, H]
        upd = sum(torch.einsum("bkhp,bkhn->bhpn", part, bf[:, sl])
                  for part in _hi_lo(xf[:, sl] * wend[..., None]))
        prev = torch.zeros((bs, h, p, n)) if state is None else state
        state = prev * torch.exp(cum[:, -1])[:, :, None, None] + upd
    return torch.cat(ys, dim=1).to(x.dtype), state


@pytest.mark.parametrize("n,chunk,g,init", [(128, 128, 1, False),
                                            (128, 64, 1, True),
                                            (64, 128, 2, True)])
def test_ssd_tensor_core_emulation_matches_references(n, chunk, g, init):
    rng = np.random.default_rng(3)
    bs, ln, h, p = 2, 256, 4, 64
    arrs = {"x": rng.standard_normal((bs, ln, h, p)),
            "dt": rng.uniform(0.001, 0.1, (bs, ln, h)),
            "a_log": rng.uniform(-0.5, 1.5, h),
            "b": rng.standard_normal((bs, ln, g, n)),
            "c": rng.standard_normal((bs, ln, g, n))}
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    # bf16 inputs, as the instance takes them (dt and a_log stay f32)
    t = {k: torch.from_numpy(v) for k, v in arrs.items()}
    for k in ("x", "b", "c"):
        t[k] = t[k].to(torch.bfloat16)
    s0 = (torch.from_numpy(rng.standard_normal((bs, h, p, n)).astype(
        np.float32)) if init else None)
    args = (t["x"], t["dt"], t["a_log"], t["b"], t["c"], chunk)
    assert ssd_scan.ssd_instance(t["x"], t["b"], chunk, t["c"]) == \
        "tensor_core"
    y, s = ssd_tensor_core_emulation(*args, s0)
    jy, js = ops.ssd(*(jnp.asarray(t[k].float().numpy(), jnp.bfloat16)
                       if k in ("x", "b", "c") else jnp.asarray(arrs[k])
                       for k in ("x", "dt", "a_log", "b", "c")),
                     chunk=chunk, mode="ref",
                     init_state=None if s0 is None else jnp.asarray(
                         s0.numpy()))
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(jy, np.float32), **BF16_TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js, np.float32),
                               **BF16_TOL)
    py, ps = ssd_scan.ssd_plain(*args, s0)
    torch.testing.assert_close(y.float(), py.float(), **BF16_TOL)
    torch.testing.assert_close(s, ps, **BF16_TOL)
