"""Hand-written Hopper kernels of the port, one wrapper module each.

Every wrapper takes its plain PyTorch version for CPU tensors and launches
its CUDA kernel for CUDA tensors (or raises); there is no fallback. The
contention wrappers take host columns (lists, numpy arrays or CPU tensors)
and pick by their ``device`` argument instead. Each
wrapper carries ``.counts`` (launches, plain calls, plain calls on CUDA
tensors, and launches by instance where the wrapper picks one, as flash
attention does, or launches two, as decode attention does, with each
one's last grid where the wrapper records it) so that a run can show
which path it went through. A replayed stage program (a CUDA graph) adds
the launches its capture recorded to these counts at each replay, and
``_lib.stage_graphs`` counts its captures and replays.
"""
from . import _lib
from . import contention_eta as _ce
from . import decode_attention as _dec
from . import flash_attention as _fa
from . import rmsnorm as _rms
from . import ssd_scan as _ssd

KERNELS = {
    "rmsnorm": _rms.rmsnorm,
    "rmsnorm_residual": _rms.rmsnorm_residual,
    "decode_attention": _dec.decode_attention,
    "flash_attention": _fa.flash_attention,
    "contention_eta_f64": _ce.fused,         # also behind _ce.rates
    "contention_eta_f32": _ce.fused_f32,
    "ssd": _ssd.ssd,
}


def reset_counts() -> None:
    for fn in KERNELS.values():
        fn.counts.reset()
    _lib.stage_graphs.reset()


__all__ = ["KERNELS", "reset_counts"]
