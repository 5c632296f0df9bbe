"""The port on the card: each CUDA kernel against its plain version, and
staged LM decode served on per-lane CUDA streams through the kernels.

Every test here is marked ``cuda`` and skips without a CUDA device; on the
card run ``python -m pytest -q -m cuda tests/test_torch_cuda.py``. The file
imports neither jax nor repro, so it runs where only the port is installed.
Tolerances are tests/test_kernels.py's: 2e-4 in f32, 3e-2 in bf16.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch import api  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.kernels import decode_attention as dec  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import rmsnorm as rms  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving.engine import staged_lm_taskspec  # noqa: E402

DTYPES = {"float32": (torch.float32, 2e-4), "bfloat16": (torch.bfloat16, 3e-2)}


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (chip_smoke.py makes the "
                    "same checks on the card)")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernels_match_plain_versions(dtype):
    _need_cuda()
    tdt, tol = DTYPES[dtype]
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=g).to(tdt).cuda()
    x, res, w = r(37, 96), r(37, 96), r(96)
    torch.testing.assert_close(rms.rmsnorm(x, w), rms.rmsnorm_plain(x, w),
                               rtol=tol, atol=tol)
    for a, b in zip(rms.rmsnorm_residual(x, res, w),
                    rms.rmsnorm_residual_plain(x, res, w)):
        torch.testing.assert_close(a, b, rtol=tol, atol=tol)
    # Dh 64 takes the 16-byte tile loads, Dh 60 the scalar ones
    for dh in (64, 60):
        q, k, v = r(3, 9, 70, dh), r(3, 3, 70, dh), r(3, 3, 70, dh)
        for window in (0, 16):
            torch.testing.assert_close(
                fa.flash_attention(q, k, v, window=window),
                fa.flash_attention_plain(q, k, v, window=window),
                rtol=tol, atol=tol)
        kv_pos = torch.arange(70, dtype=torch.int32).cuda()
        q_pos = torch.tensor([69, 30, 5], dtype=torch.int32).cuda()
        torch.testing.assert_close(
            dec.decode_attention(q[:, :, 0], k, v, kv_pos, q_pos),
            dec.decode_attention_plain(q[:, :, 0], k, v, kv_pos, q_pos),
            rtol=tol, atol=tol)


@pytest.mark.cuda
def test_realtime_staged_lm_decode_on_cuda_streams():
    _need_cuda()
    from repro_torch.kernels import KERNELS, reset_counts
    model = build_model(get_reduced("smollm-135m").replace(n_layers=8,
                                                           dtype="bfloat16"))
    reset_counts()
    spec = staged_lm_taskspec(model, priority=api.HP, jps=20.0, batch=2)
    srv = (api.ServerConfig.realtime().tasks([spec]).contexts(2).streams(2)
           .oversubscribe(2.0).device(api.DeviceModel(n_units=2.0))
           .horizon_ms(800.0).build())
    m = srv.run()
    assert m.completed[api.HP] > 0
    assert srv.backend.worker_exceptions == 0
    assert all(fn.counts.launches > 0 for fn in KERNELS.values())
    assert all(fn.counts.plain_cuda_calls == 0 for fn in KERNELS.values())
