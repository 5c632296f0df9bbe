"""Model primitives of the LM paths: norms, gated MLP, rope, init.

Counterpart of src/repro/models/layers.py. Functions take tensors and
dicts of tensors with the JAX package's layouts (``w_gate/w_up [d, ff]``,
``w_down [ff, d]``). The norms go through the kernel wrappers
(``kernels/rmsnorm.py``): CUDA tensors launch the Hopper kernel, CPU
tensors its plain version.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

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


def gated_mlp(params: dict, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    g = x @ params["w_gate"]
    u = x @ params["w_up"]
    return (act_fn(act)(g) * u) @ params["w_down"]


# ---------------------------------------------------------------------------
# Rotary position embeddings (f32 inside, cast back)
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, Dh]; positions: broadcastable to [..., S]."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                 # [Dh/2]
    ang = positions[..., :, None].float() * freqs           # [..., S, Dh/2]
    cos = torch.cos(ang)[..., :, None, :]                   # [..., S, 1, Dh/2]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
