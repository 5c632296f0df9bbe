"""The port's kernel wrappers against the JAX package's oracles.

On the CPU every wrapper runs its plain PyTorch version; each is held to
``repro.kernels.ref`` (JAX, inputs and outputs passed through numpy) at the
shapes and dtypes of tests/test_kernels.py, with its tolerances: 2e-4 in
f32, 3e-2 in bf16. The fused residual norm is also held to the Pallas
kernel itself in interpret mode, whose order (norm of the unrounded f32
sum) the port keeps. The CUDA kernels are held to these plain versions on
the card by tests/test_torch_cuda.py and chip_smoke.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import rmsnorm as pallas_rms  # noqa: E402

from repro_torch.kernels import KERNELS, reset_counts  # noqa: E402
from repro_torch.kernels import decode_attention as dec  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import rmsnorm as rms  # noqa: E402
from repro_torch.runtime.contention import DeviceModel  # noqa: E402

DTYPES = {"float32": (torch.float32, jnp.float32, 2e-4),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 3e-2)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread keeps these tests
    from taking every core from wall-clock tests in other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(rng, shape, dtype):
    """The same values as a torch tensor and a jax array (bf16 rounds the
    same f32 numbers to nearest even on both sides)."""
    x = rng.normal(size=shape).astype(np.float32)
    tdt, jdt, _ = DTYPES[dtype]
    return torch.from_numpy(x).to(tdt), jnp.asarray(x, jdt)


def _close(ours, ref, tol):
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("m,d", [(64, 128), (100, 96), (256, 512)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("plus_one", [False, True])
def test_rmsnorm_matches_reference(m, d, dtype, plus_one):
    rng = np.random.default_rng(0)
    x, jx = _pair(rng, (m, d), dtype)
    w, jw = _pair(rng, (d,), "float32")
    out = rms.rmsnorm(x, w, plus_one=plus_one)
    assert out.dtype == x.dtype and out.shape == x.shape
    _close(out, jref.rmsnorm_ref(jx, jw, plus_one=plus_one),
           DTYPES[dtype][2])


def test_rmsnorm_residual_matches_reference_f32():
    """In f32 the reference oracle's order (round s, then norm) and the
    kernel's agree, so the oracle is the target."""
    rng = np.random.default_rng(1)
    x, jx = _pair(rng, (96, 256), "float32")
    r, jr = _pair(rng, (96, 256), "float32")
    w, jw = _pair(rng, (256,), "float32")
    y, s = rms.rmsnorm_residual(x, r, w)
    jy, js = jref.rmsnorm_residual_ref(jx, jr, jw)
    _close(y, jy, 2e-5)
    _close(s, js, 2e-5)


@pytest.mark.parametrize("m,d", [(4, 576), (96, 256)])
def test_rmsnorm_residual_keeps_pallas_order_bf16(m, d):
    """In bf16 the port norms the unrounded f32 sum, as the Pallas kernel
    (interpret mode) does: the two agree to within one bf16 rounding."""
    rng = np.random.default_rng(2)
    x, jx = _pair(rng, (m, d), "bfloat16")
    r, jr = _pair(rng, (m, d), "bfloat16")
    w, jw = _pair(rng, (d,), "bfloat16")
    y, s = rms.rmsnorm_residual(x, r, w)
    py, ps = pallas_rms.rmsnorm_residual(jx, jr, jw, interpret=True)
    np.testing.assert_array_equal(s.float().numpy(), np.asarray(ps, np.float32))
    _close(y, py, 2.0 ** -7)


@pytest.mark.parametrize("h,kv,s,dh", [(8, 8, 256, 64), (8, 2, 256, 64),
                                       (4, 1, 128, 32), (9, 3, 512, 64),
                                       (4, 4, 130, 112), (4, 1, 96, 160),
                                       (4, 4, 70, 192)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_reference(h, kv, s, dh, dtype):
    rng = np.random.default_rng(3)
    q, jq = _pair(rng, (2, h, s, dh), dtype)
    k, jk = _pair(rng, (2, kv, s, dh), dtype)
    v, jv = _pair(rng, (2, kv, s, dh), dtype)
    _close(fa.flash_attention(q, k, v), jref.attention_ref(jq, jk, jv),
           DTYPES[dtype][2])


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (64, 0.0), (0, 30.0),
                                            (32, 50.0)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_masks(window, softcap, causal):
    rng = np.random.default_rng(4)
    q, jq = _pair(rng, (1, 4, 128, 64), "float32")
    k, jk = _pair(rng, (1, 2, 128, 64), "float32")
    v, jv = _pair(rng, (1, 2, 128, 64), "float32")
    ours = fa.flash_attention(q, k, v, causal=causal, window=window,
                              softcap=softcap)
    _close(ours, jref.attention_ref(jq, jk, jv, causal=causal, window=window,
                                    softcap=softcap), 2e-4)


@pytest.mark.parametrize("s,s_kv,h,kv", [(5, 37, 4, 2), (64, 150, 6, 6),
                                         (1, 70, 4, 4)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_keys_of_their_own_length(s, s_kv, h, kv, dtype):
    """Cross-attention: k/v of S_kv rows, not causal, against a direct
    softmax in float64 and against the reference's ``mha`` (which computes
    whisper's cross-attention) on the same inputs."""
    from repro.models.attention import mha
    rng = np.random.default_rng(s + s_kv)
    q, jq = _pair(rng, (2, h, s, 64), dtype)
    k, jk = _pair(rng, (2, kv, s_kv, 64), dtype)
    v, jv = _pair(rng, (2, kv, s_kv, 64), dtype)
    ours = fa.flash_attention(q, k, v, causal=False)
    assert ours.shape == (2, h, s, 64)
    qd, kd, vd = (t.double().numpy() for t in (q, k, v))
    kd, vd = (np.repeat(t, h // kv, axis=1) for t in (kd, vd))
    logits = np.einsum("bhqd,bhtd->bhqt", qd, kd) / 8.0
    p = np.exp(logits - logits.max(-1, keepdims=True))
    direct = np.einsum("bhqt,bhtd->bhqd", p / p.sum(-1, keepdims=True), vd)
    tol = DTYPES[dtype][2]
    _close(ours, direct, tol)
    ref = mha(jq.swapaxes(1, 2), jk.swapaxes(1, 2), jv.swapaxes(1, 2),
              q_positions=jnp.arange(s), kv_positions=jnp.arange(s_kv),
              causal=False)
    _close(ours, ref.swapaxes(1, 2), tol)


def test_flash_attention_refuses_causal_with_other_key_length():
    q = torch.zeros((1, 2, 8, 16))
    kv = torch.zeros((1, 2, 12, 16))
    with pytest.raises(ValueError, match="causal"):
        fa.flash_attention(q, kv, kv)
    with pytest.raises(ValueError, match="causal"):
        fa.flash_attention(q, kv, kv, causal=True, window=4)
    assert fa.flash_attention(q, kv, kv, causal=False).shape == (1, 2, 8, 16)


def test_launch_keys_name_the_options():
    """The shape keys that chip_smoke.py's coverage check compares name
    what a launch masks and caps, so a plain causal row cannot stand for
    a softcapped, windowed, non-causal or cross-attention launch."""
    from repro_torch.kernels import _lib
    assert _lib.options_key() == ""
    assert _lib.options_key(s_kv=(512, 512)) == ""
    assert _lib.options_key(s_kv=(1500, 64), full=True) == " Skv1500 full"
    assert _lib.options_key(window=4096, softcap=50.0) == " window softcap"


def _decode_inputs(rng, h, kv, s, fill, dtype="float32", batch=2):
    q, jq = _pair(rng, (batch, h, 64), dtype)
    k, jk = _pair(rng, (batch, kv, s, 64), dtype)
    v, jv = _pair(rng, (batch, kv, s, 64), dtype)
    n_valid = int(s * fill)
    kv_pos = np.where(np.arange(s) < n_valid, np.arange(s), -1).astype(np.int32)
    q_pos = np.asarray([n_valid - 1, n_valid // 2], np.int32)[:batch]
    return ((q, k, v, torch.from_numpy(kv_pos), torch.from_numpy(q_pos)),
            (jq, jk, jv, jnp.asarray(kv_pos), jnp.asarray(q_pos)))


@pytest.mark.parametrize("h,kv,s", [(8, 8, 512), (8, 2, 512), (4, 4, 256),
                                    (9, 3, 513)])
@pytest.mark.parametrize("fill", [1.0, 0.6])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_reference(h, kv, s, fill, dtype):
    rng = np.random.default_rng(5)
    ours, ref = _decode_inputs(rng, h, kv, s, fill, dtype)
    _close(dec.decode_attention(*ours), jref.decode_attention_ref(*ref),
           DTYPES[dtype][2])


@pytest.mark.parametrize("window,softcap", [(64, 0.0), (0, 30.0), (32, 50.0)])
def test_decode_attention_masks(window, softcap):
    rng = np.random.default_rng(6)
    ours, ref = _decode_inputs(rng, 8, 2, 256, 0.6)
    _close(dec.decode_attention(*ours, window=window, softcap=softcap),
           jref.decode_attention_ref(*ref, window=window, softcap=softcap),
           2e-4)


def test_decode_attention_fully_masked_row_averages_values():
    """A query that sees no slot gets the mean of V, as the Pallas kernel
    and the oracle give it (masked logits are -1e30, not -inf)."""
    rng = np.random.default_rng(7)
    (q, k, v, kv_pos, _), (jq, jk, jv, jkp, _) = _decode_inputs(
        rng, 4, 2, 64, 1.0)
    q_pos = torch.tensor([-1, -1], dtype=torch.int32)
    ours = dec.decode_attention(q, k, v, kv_pos, q_pos)
    _close(ours, jref.decode_attention_ref(jq, jk, jv, jkp,
                                           jnp.asarray([-1, -1])), 2e-4)
    np.testing.assert_allclose(ours[:, 0].numpy(),
                               v[:, 0].mean(dim=1).numpy(), atol=1e-5)


def test_decode_attention_reads_cache_layout_through_strides():
    """The model hands the [B, T, KV, Dh] cache as a transposed view."""
    rng = np.random.default_rng(8)
    (q, k, v, kv_pos, q_pos), _ = _decode_inputs(rng, 8, 2, 128, 0.6)
    kc, vc = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    ours = dec.decode_attention(q, kc.transpose(1, 2), vc.transpose(1, 2),
                                kv_pos, q_pos)
    torch.testing.assert_close(ours, dec.decode_attention(q, k, v, kv_pos,
                                                          q_pos))


def test_cpu_calls_count_plain_versions_only():
    reset_counts()
    x = torch.randn(4, 64)
    rms.rmsnorm(x, torch.ones(64))
    rms.rmsnorm_residual(x, x, torch.ones(64))
    for name, fn in KERNELS.items():
        assert fn.counts.launches == 0
        assert fn.counts.plain_cuda_calls == 0
    assert rms.rmsnorm.counts.plain_calls == 1
    assert rms.rmsnorm_residual.counts.plain_calls == 1
    reset_counts()
    assert rms.rmsnorm.counts.plain_calls == 0


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_non_cpu_tensors_never_fall_back_to_plain(name):
    """A tensor off the CPU never falls back to the plain version. The
    contention kernel's path raises for any device but CUDA; the four
    operator-backed wrappers (``repro_torch::*``) give meta tensors their
    outputs' shapes from the fake kernel (the dry-run's use), with no
    launch and no plain call."""
    m = torch.device("meta")
    lanes = ([1.0, 2.0], [4.0, 4.0], [0.5, 0.5], [1.0, 1.0])
    kwargs = {"contention_eta_f64": {"device": m},
              "contention_eta_f32": {"device": m}}.get(name, {})
    args = {
        "rmsnorm": (torch.empty(4, 8, device=m), torch.empty(8, device=m)),
        "rmsnorm_residual": (torch.empty(4, 8, device=m),
                             torch.empty(4, 8, device=m),
                             torch.empty(8, device=m)),
        "decode_attention": (torch.empty(2, 4, 8, device=m),
                             torch.empty(2, 2, 16, 8, device=m),
                             torch.empty(2, 2, 16, 8, device=m),
                             torch.empty(16, dtype=torch.int32, device=m),
                             torch.empty(2, dtype=torch.int32, device=m)),
        "flash_attention": (torch.empty(2, 4, 16, 8, device=m),
                            torch.empty(2, 2, 16, 8, device=m),
                            torch.empty(2, 2, 16, 8, device=m)),
        "contention_eta_f64": (DeviceModel(), 0.0, *lanes),
        "contention_eta_f32": (DeviceModel(), 0.0, *lanes),
        "ssd": (torch.empty(1, 8, 2, 4, device=m),
                torch.empty(1, 8, 2, device=m), torch.empty(2, device=m),
                torch.empty(1, 8, 1, 4, device=m),
                torch.empty(1, 8, 1, 4, device=m), 8),
    }[name]
    reset_counts()
    if name.startswith("contention"):
        with pytest.raises(ValueError, match="CUDA"):
            KERNELS[name](*args, **kwargs)
    else:
        out = KERNELS[name](*args, **kwargs)
        first = out[0] if isinstance(out, tuple) else out
        assert first.device == m and first.shape == args[0].shape
        assert KERNELS[name].counts.launches == 0
    assert KERNELS[name].counts.plain_calls == 0
