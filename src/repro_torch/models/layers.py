"""Model primitives of the LM paths: norms, gated MLP, rope, init.

Counterpart of src/repro/models/layers.py. Functions take tensors and
dicts of tensors with the JAX package's layouts (``w_gate/w_up [d, ff]``,
``w_down [ff, d]``). The RMS norms go through the kernel wrappers
(``kernels/rmsnorm.py``): CUDA tensors launch the Hopper kernel, CPU
tensors its plain version. Whisper's LayerNorm, biased MLP and position
table, and gemma2's logit softcap, are plain torch ops, as they are plain
``jnp`` in the reference.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import rmsnorm as _rms


# ---------------------------------------------------------------------------
# Initializers: the distributions of the reference (truncated normal at two
# standard deviations with 1/sqrt(fan_in) scaling, embeddings N(0, 0.02)),
# drawn from a torch.Generator. They do not reproduce JAX's numbers.
# ---------------------------------------------------------------------------
def dense_init(gen: torch.Generator, shape: Sequence[int], dtype: torch.dtype,
               *, fan_in: int, scale: Optional[float] = None,
               device: Optional[torch.device] = None) -> torch.Tensor:
    std = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return w.mul_(std).to(dtype)     # in place: one f32 copy of a large leaf


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype: torch.dtype,
               device: Optional[torch.device] = None) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                    device=device) * 0.02
    return w.to(dtype)


def init_mlp(gen: torch.Generator, d: int, d_ff: int, dtype: torch.dtype,
             *, device: Optional[torch.device] = None) -> dict:
    """Plain two-layer MLP with biases (whisper)."""
    return {
        "w_in": dense_init(gen, (d, d_ff), dtype, fan_in=d, device=device),
        "b_in": torch.zeros(d_ff, dtype=dtype, device=device),
        "w_out": dense_init(gen, (d_ff, d), dtype, fan_in=d_ff,
                            device=device),
        "b_out": torch.zeros(d, dtype=dtype, device=device),
    }


def init_gated_mlp(gen: torch.Generator, d: int, d_ff: int,
                   dtype: torch.dtype, *, lead=(),
                   device: Optional[torch.device] = None) -> dict:
    lead = tuple(lead)
    return {
        "w_gate": dense_init(gen, lead + (d, d_ff), dtype, fan_in=d,
                             device=device),
        "w_up": dense_init(gen, lead + (d, d_ff), dtype, fan_in=d,
                           device=device),
        "w_down": dense_init(gen, lead + (d_ff, d), dtype, fan_in=d_ff,
                             device=device),
    }


# ---------------------------------------------------------------------------
# Norms (f32 inside whatever the parameter dtype)
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
             plus_one: bool = False) -> torch.Tensor:
    return _rms.rmsnorm(x, weight, eps=eps, plus_one=plus_one)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    y = F.layer_norm(x.float(), (x.shape[-1],), weight.float(), bias.float(),
                     eps)
    return y.to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma2-style logit soft-capping: cap * tanh(x / cap), in f32."""
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


# ---------------------------------------------------------------------------
# Activations / MLP
# ---------------------------------------------------------------------------
def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


# jax.nn.gelu approximates with tanh by default, so "gelu" does too
_ACTS = {"silu": F.silu, "gelu": _gelu_tanh, "gelu_tanh": _gelu_tanh}


def act_fn(name: str):
    if name not in _ACTS:
        raise ValueError(f"unknown activation {name}")
    return _ACTS[name]


def gated_mlp(params: dict, x: torch.Tensor, act: str = "silu",
              cons=None, region=None) -> torch.Tensor:
    """``region`` (``parallel.sharding.Region``): where ``region.split``
    the ffn axis is this rank's slice and the output is summed over the
    model axis; under sequence parallelism ``x`` is this rank's rows."""
    if region is not None:
        x = region.enter(x)
    g = x @ params["w_gate"]
    u = x @ params["w_up"]
    h = act_fn(act)(g) * u
    if cons is not None:
        h = cons.ffn(h)
    out = h @ params["w_down"]
    return out if region is None else region.leave(out)


def mlp(params: dict, x: torch.Tensor, act: str = "gelu",
        region=None) -> torch.Tensor:
    if region is not None:
        x = region.enter(x)
    h = act_fn(act)(x @ params["w_in"] + params["b_in"])
    out = h @ params["w_out"]
    if region is not None:
        out = region.leave(out)
    return out + params["b_out"]


# ---------------------------------------------------------------------------
# Rotary position embeddings (f32 inside, cast back)
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float,
                device: Optional[torch.device] = None) -> tuple:
    """(cos, sin) [..., S, 1, Dh/2] in f32 for ``positions`` (broadcastable
    to [..., S]): what every layer of a stack with one theta and head
    width shares, so a stage builds them once (XLA's CSE does so inside
    the reference's jitted stage)."""
    freqs = rope_freqs(head_dim, theta, device)             # [Dh/2]
    ang = positions[..., :, None].float() * freqs           # [..., S, Dh/2]
    return torch.cos(ang)[..., :, None, :], torch.sin(ang)[..., :, None, :]


def rope_apply(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: [..., S, H, Dh] rotated by ``rope_tables``' (cos, sin)."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, Dh]; positions: broadcastable to [..., S]."""
    return rope_apply(x, *rope_tables(positions, x.shape[-1], theta,
                                      x.device))


def sinusoidal_positions(n: int, d: int) -> torch.Tensor:
    """Whisper-style sinusoidal position table [n, d] (f32; computed in
    float64 with numpy, as the reference computes it)."""
    pos = np.arange(n)[:, None]
    dim = np.arange(d // 2)[None, :]
    inv = 1.0 / (10000 ** (dim / max(d // 2 - 1, 1)))
    ang = pos * inv
    return torch.from_numpy(np.concatenate([np.sin(ang), np.cos(ang)],
                                           axis=1).astype(np.float32))
