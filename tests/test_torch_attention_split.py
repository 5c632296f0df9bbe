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
  functions of shapes, dtypes, strides and alignment.
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
