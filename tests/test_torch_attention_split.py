"""The choices the attention wrappers make before they launch, on the CPU.

- Decode attention splits each sequence's cache into ``n_split`` chunks
  and merges the per-chunk partials (m, l, acc). ``split_merge_decode``
  below does on the CPU, in f32, what the split and combine kernels do on
  the card, and is held to ``repro.kernels.ref.decode_attention_ref`` (JAX,
  through numpy) at several split counts, with its masks and the edge
  cases the merge must keep: a fill of 0.6 (empty slots), a window, a
  softcap, a row that sees no slot, and S = 513 (a ragged last chunk).
  Tolerance 2e-4 (f32, as tests/test_kernels.py).
- ``decode_split`` (slots per split, number of splits) and
  ``flash_instance`` (tensor-core or CUDA-core flash attention) are plain
  functions of shapes, dtypes, strides and alignment; ``flash_plan`` (the
  tensor-core launch's padded width, ring, tile and shared memory) of the
  head dimension.
- ``flash_tensor_core_emulation`` does on the CPU, in f32, what the
  tensor-core flash instance does on the card at a head dimension padded
  to whole 64-column blocks (Dh 112, 160, 192): 64-key tiles, the base-2
  online softmax, P rounded to bf16 before P V over the padded width, the
  output cut back to Dh. It is held to ``repro.kernels.ref.attention_ref``
  (JAX, bf16 inputs, through numpy) and to the port's plain version at
  the bf16 tolerance 3e-2 of tests/test_kernels.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402

from repro_torch.kernels import KERNELS, _lib, reset_counts  # noqa: E402
from repro_torch.kernels import decode_attention as dec  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import rmsnorm as rms  # noqa: E402

NEG_INF = -1.0e30
H100_SMS = 132


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread keeps these tests from taking every core from
    wall-clock tests in other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def split_merge_decode(q, k, v, kv_pos, q_pos, n_split, *, window=0,
                       softcap=0.0):
    """Decode attention as the split kernel and its merge compute it:
    chunks of ceil(S / n_split) slots, each with its own max (starting at
    -1e30), sum and weighted V; then m = max m_i,
    out = sum acc_i e^(m_i - m) / max(sum l_i e^(m_i - m), 1e-30)."""
    b, h, dh = q.shape
    kvh, s = k.shape[1], k.shape[2]
    chunk = -(-s // n_split)
    n = -(-s // chunk)
    assert (n - 1) * chunk < s <= n * chunk
    logits = torch.einsum("bkgd,bktd->bkgt", q.reshape(b, kvh, -1, dh).float(),
                          k.float()) * dh ** -0.5
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    kp, qp = kv_pos.long()[None], q_pos.long()[:, None]
    ok = (kp >= 0) & (kp <= qp)
    if window > 0:
        ok = ok & (qp - kp < window)
    logits = torch.where(ok[:, None, None], logits,
                         torch.full_like(logits, NEG_INF))
    ms, ls, accs = [], [], []
    for i in range(n):
        sl = slice(i * chunk, min(s, (i + 1) * chunk))
        m = logits[..., sl].amax(-1).clamp_min(NEG_INF)
        p = torch.exp(logits[..., sl] - m[..., None])
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bkgt,bktd->bkgd", p, v[:, :, sl].float()))
    m = torch.stack(ms)
    w = torch.exp(m - m.amax(0))
    den = (torch.stack(ls) * w).sum(0).clamp_min(1e-30)
    acc = (torch.stack(accs) * w[..., None]).sum(0)
    return (acc / den[..., None]).reshape(b, h, dh)


def _inputs(s=513, h=9, kv=3, fill=0.6):
    rng = np.random.default_rng(11)
    q, k, v = (rng.normal(size=shape).astype(np.float32)
               for shape in ((3, h, 64), (3, kv, s, 64), (3, kv, s, 64)))
    n_valid = int(s * fill)
    kv_pos = np.where(np.arange(s) < n_valid, np.arange(s), -1).astype(
        np.int32)
    q_pos = np.asarray([n_valid - 1, n_valid // 2, -1], np.int32)
    arrays = (q, k, v, kv_pos, q_pos)
    return (tuple(torch.from_numpy(a) for a in arrays),
            tuple(jnp.asarray(a) for a in arrays))


@pytest.mark.parametrize("n_split", [1, 2, 17, 513])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (64, 0.0), (0, 30.0),
                                            (32, 50.0)])
def test_split_merge_matches_reference(n_split, window, softcap):
    """Fill 0.6, row 2 sees no slot (q_pos = -1), S = 513; 513 splits is
    one chunk per slot."""
    ours, ref = _inputs()
    got = split_merge_decode(*ours, n_split, window=window, softcap=softcap)
    want = jref.decode_attention_ref(*ref, window=window, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    # the masked row is the mean of V over all S slots, whatever the split
    v = ours[2]
    np.testing.assert_allclose(got[2].numpy(),
                               v[2].mean(dim=1).repeat_interleave(3, 0)
                               .numpy(), atol=1e-5)


@pytest.mark.parametrize("s,b", [(1, 1), (70, 1), (513, 3), (4096, 3)])
def test_split_merge_at_the_wrappers_choice(s, b):
    """The split count the wrapper picks gives the plain version's result."""
    ours, _ = _inputs(s=s, fill=1.0)
    q, k, v, kv_pos, q_pos = ours
    q, k, v, q_pos = q[:b], k[:b], v[:b], q_pos[:b]
    _, n_split = dec.decode_split(s, b, k.shape[1], H100_SMS)
    got = split_merge_decode(q, k, v, kv_pos, q_pos, n_split, window=16)
    want = dec.decode_attention_plain(q, k, v, kv_pos, q_pos, window=16)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                               atol=2e-4)


def test_decode_split_fills_the_card_at_the_path_shapes():
    """smollm-135m decode: B 4, KV 3, a 513-slot cache."""
    chunk, n_split = dec.decode_split(513, 4, 3, H100_SMS)
    assert 4 * 3 * n_split >= H100_SMS
    assert (chunk, n_split) == (32, 17)
    chunk, n_split = dec.decode_split(4096, 4, 3, H100_SMS)
    assert 4 * 3 * n_split >= dec.BLOCKS_PER_SM * H100_SMS


@pytest.mark.parametrize("s", [1, 2, 15, 16, 17, 70, 513, 4096, 32768])
@pytest.mark.parametrize("b,kvh", [(1, 1), (1, 3), (4, 3), (8, 8)])
@pytest.mark.parametrize("n_sm", [H100_SMS, 114])
def test_decode_split_never_starts_a_split_past_s(s, b, kvh, n_sm):
    chunk, n_split = dec.decode_split(s, b, kvh, n_sm)
    assert dec.MIN_CHUNK <= chunk <= dec.MAX_CHUNK
    assert chunk % dec.CHUNK_STEP == 0
    assert (n_split - 1) * chunk < s <= n_split * chunk


def _path_qkv(dtype=torch.bfloat16, dh=64, width=None, s=512):
    """The prefill's q/k/v: transposed views of [B, S, heads, Dh] arrays
    (``width`` > Dh cuts the head dimension out of a wider array)."""
    width = width or dh
    return tuple(torch.zeros((4, s, n, width), dtype=dtype)[..., :dh]
                 .transpose(1, 2) for n in (9, 3, 3))


def test_flash_instance_takes_tensor_cores_on_the_path():
    assert fa.flash_instance(*_path_qkv()) == "tensor_core"
    assert fa.flash_instance(*_path_qkv(dh=128)) == "tensor_core"
    contiguous = [t.contiguous() for t in _path_qkv(s=70)]
    assert fa.flash_instance(*contiguous) == "tensor_core"


def _mla_qkv(dtype):
    """MLA's prefill: H = KV, q and k at 192 (nope 128 + rope 64), v
    zero-padded from 128 to 192 (the model's ``_pad_v``)."""
    q, k = (torch.zeros((4, 512, 8, 192), dtype=dtype).transpose(1, 2)
            for _ in range(2))
    v = torch.nn.functional.pad(torch.zeros((4, 512, 8, 128), dtype=dtype),
                                (0, 64)).transpose(1, 2)
    return q, k, v


@pytest.mark.parametrize("dh", [112, 160, 192])
def test_flash_instance_takes_tensor_cores_at_the_padded_widths(dh):
    """zamba2's shared block (112), stablelm (160), deepseek-v2's MLA
    prefill (192): bf16 on the tensor cores through the model's transposed
    layout, f32 on the CUDA cores (TF32 would miss 2e-4)."""
    assert fa.flash_instance(*_path_qkv(dh=dh)) == "tensor_core"
    assert fa.flash_instance(*_path_qkv(torch.float32, dh=dh)) == \
        "cuda_core"
    if dh == 192:
        assert fa.flash_instance(*_mla_qkv(torch.bfloat16)) == "tensor_core"
        assert fa.flash_instance(*_mla_qkv(torch.float32)) == "cuda_core"


# (Dh: padded width, tile bytes, K/V stages, shared bytes), 1024-aligned
# base, Q, then a (K, V) pair a stage. Dh 64 and 128 keep the two-stage
# ring; 112, 160 and 192 hold one stage, which fits more blocks an SM
PLANS = {64: (64, 8192, 2, 41984),
         112: (128, 16384, 1, 50176),
         128: (128, 16384, 2, 82944),
         160: (192, 24576, 1, 74752),
         192: (192, 24576, 1, 74752)}


@pytest.mark.parametrize("dh", sorted(PLANS))
def test_flash_plan_at_every_tensor_core_width(dh):
    dp, tile, stages, nbytes = PLANS[dh]
    plan = fa.flash_plan(dh)
    assert (plan.dp, plan.tile_bytes, plan.stages, plan.smem_bytes) == \
        (dp, tile, stages, nbytes)
    assert nbytes <= 232_448                # a block's most on the H100
    assert plan.blocks_per_sm == 233_472 // (nbytes + 1024) >= 2
    assert tile == 64 * dp * 2 and dp % 64 == 0 and dp - dh < 64


@pytest.mark.parametrize("dh", [16, 32, 48, 60, 80, 96, 144, 256])
def test_flash_plan_refuses_what_no_instance_is_built_for(dh):
    with pytest.raises(ValueError, match="no tensor-core instance"):
        fa.flash_plan(dh)


LOG2E = 1.4426950408889634


def flash_tensor_core_emulation(q, k, v, *, causal=True, window=0,
                                softcap=0.0):
    """The tensor-core flash instance's arithmetic in f32 on the CPU: the
    head dimension zero-padded to ``flash_plan(Dh).dp``; a query tile of
    64 rows walks 64-key tiles from the window's first to the causal end;
    logits Q K^T x scale (softcapped), times log2(e) where visible, -1e30
    where masked, keys past S_kv not in the tile; base-2 online softmax
    from a running max of -1e30; P rounded to bf16 before P V over the
    padded width, the row sums of the f32 P; the output cut back to Dh."""
    b, h, s, dh = q.shape
    kvh, s_kv = k.shape[1], k.shape[2]
    dp = fa.flash_plan(dh).dp

    def padded(t):
        return torch.nn.functional.pad(t.float(), (0, dp - dh))
    qf = padded(q)
    kf, vf = (padded(t).repeat_interleave(h // kvh, dim=1) for t in (k, v))
    scale = dh ** -0.5
    out = torch.empty((b, h, s, dp))
    for q0 in range(0, s, 64):
        q1 = min(q0 + 64, s)
        rows = torch.arange(q0, q1)[:, None]
        k_end = q1 if causal else s_kv
        k_begin = max(0, q0 - window + 1) // 64 * 64 if window > 0 else 0
        m = torch.full((b, h, q1 - q0), NEG_INF)
        l = torch.zeros((b, h, q1 - q0))
        acc = torch.zeros((b, h, q1 - q0, dp))
        for k0 in range(k_begin, k_end, 64):
            k1 = min(k0 + 64, s_kv)
            cols = torch.arange(k0, k1)[None]
            x = torch.einsum("bhqd,bhkd->bhqk", qf[:, :, q0:q1],
                             kf[:, :, k0:k1]) * scale
            if softcap > 0.0:
                x = softcap * torch.tanh(x / softcap)
            ok = torch.ones((q1 - q0, k1 - k0), dtype=torch.bool)
            if causal:
                ok &= cols <= rows
            if window > 0:
                ok &= rows - cols < window
            x = torch.where(ok, x * LOG2E, torch.full_like(x, NEG_INF))
            m_new = torch.maximum(m, x.amax(-1))
            p = torch.exp2(x - m_new[..., None])
            c = torch.exp2(m - m_new)
            l = l * c + p.sum(-1)
            acc = acc * c[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p.to(torch.bfloat16).float(),
                vf[:, :, k0:k1])
            m = m_new
        out[:, :, q0:q1] = acc / l.clamp_min(1e-30)[..., None]
    return out[..., :dh].to(q.dtype)


@pytest.mark.parametrize("dh", [112, 160, 192])
@pytest.mark.parametrize("causal,window,softcap", [
    (True, 0, 0.0), (True, 48, 0.0), (True, 0, 30.0), (False, 0, 0.0),
    (False, 40, 20.0)])
def test_flash_tensor_core_emulation_matches_reference(dh, causal, window,
                                                       softcap):
    """Bf16 inputs, 2 x 4 query heads over 2 KV heads, S 130 (three query
    tiles, a ragged last key tile); q scaled by 3 so that the softmax is
    peaked and the softcap bites."""
    rng = np.random.default_rng(dh)
    q, k, v = (rng.standard_normal((2, n, 130, dh)).astype(np.float32)
               for n in (4, 2, 2))
    q = q * 3.0
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    assert fa.flash_instance(tq, tk, tv) == "tensor_core"
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = flash_tensor_core_emulation(tq, tk, tv, **kw)
    want = jref.attention_ref(*(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                                for t in (tq, tk, tv)), **kw)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=3e-2,
                               atol=3e-2)
    torch.testing.assert_close(
        got.float(), fa.flash_attention_plain(tq, tk, tv, **kw).float(),
        rtol=3e-2, atol=3e-2)


def test_flash_emulation_of_mla_padded_v_keeps_its_pad_zero():
    """MLA's v zero-padded from 128 to 192: output columns 128 .. 191 are
    exactly zero, the others the reference's."""
    rng = np.random.default_rng(5)
    q, k = (rng.standard_normal((1, 4, 70, 192)).astype(np.float32)
            for _ in range(2))
    v = np.pad(rng.standard_normal((1, 4, 70, 128)).astype(np.float32),
               ((0, 0), (0, 0), (0, 0), (0, 64)))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = flash_tensor_core_emulation(tq, tk, tv)
    assert not got[..., 128:].any()
    want = jref.attention_ref(*(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                                for t in (tq, tk, tv)))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=3e-2,
                               atol=3e-2)


def test_flash_instance_keeps_the_cuda_core_kernel_where_wgmma_cannot_go():
    assert fa.flash_instance(*_path_qkv(torch.float32)) == "cuda_core"
    assert fa.flash_instance(*_path_qkv(dh=60)) == "cuda_core"
    assert fa.flash_instance(*_path_qkv(dh=32)) == "cuda_core"
    # a row stride of 68 elements is not 16-byte aligned
    assert fa.flash_instance(*_path_qkv(width=68)) == "cuda_core"
    # a base one element past an aligned one
    q, k, v = _path_qkv()
    flat = torch.zeros(q.numel() + 1, dtype=q.dtype)[1:]
    q_off = flat.view(4, 512, 9, 64).transpose(1, 2)
    assert q_off.data_ptr() % 16
    assert fa.flash_instance(q_off, k, v) == "cuda_core"


def test_instance_counts_are_per_wrapper_and_reset():
    counts = _lib.Counts()
    counts.launched("tensor_core")
    counts.launched("tensor_core")
    counts.launched("cuda_core")
    counts.launched()
    counts.launched("split", (17, 3, 4))
    counts.launched("split", (9, 3, 1))
    assert counts.launches == 6
    assert counts.by_instance == {"tensor_core": 2, "cuda_core": 1,
                                  "split": 2}
    assert counts.grids == {"split": (9, 3, 1)}      # the last launch's
    counts.reset()
    assert counts.launches == 0 and counts.by_instance == {}
    assert counts.grids == {}
    fa.flash_attention.counts.launched("tensor_core")
    dec.decode_attention.counts.launched("combine", (9, 4))
    reset_counts()
    assert all(fn.counts.by_instance == {} and fn.counts.grids == {}
               for fn in KERNELS.values())


def test_launches_are_counted_by_instance_and_shape():
    counts = _lib.Counts()
    counts.launched("block", (1,), "4x2048")
    counts.launched("block", (1,), "4x2048")
    counts.launched("warp", (512,), "2048x2048")
    counts.launched(shape="B4 H16 KV16 Dh128")
    counts.launched("block", (1,))                   # no shape given
    assert counts.launches == 5
    assert counts.by_shape == {"block 4x2048": 2, "warp 2048x2048": 1,
                               "B4 H16 KV16 Dh128": 1}
    assert counts.by_instance == {"block": 3, "warp": 1}
    rms.rmsnorm.counts.launched("block", (1,), "4x576")
    reset_counts()
    assert counts.by_shape and all(fn.counts.by_shape == {}
                                   for fn in KERNELS.values())
