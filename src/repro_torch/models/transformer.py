"""Decoder-only LM assembly: the dense and ssm (Mamba2) families.

Counterpart of src/repro/models/transformer.py for ``family == "dense"``
(without gemma2's local/global alternation or post-norms) and
``family == "ssm"`` (``[mamba2] x L``). Layers are stacked
on a leading ``[L, ...]`` axis as in the reference; the reference's
``lax.scan`` over them becomes a loop over that axis, and the stacked cache
is rebuilt from the per-layer caches the loop returns.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..kernels.rmsnorm import rmsnorm_residual
from .attention import attention_block, init_attention, make_kv_cache
from .layers import dense_init, embed_init, gated_mlp, rms_norm
from .mamba2 import init_mamba2, make_ssm_cache, mamba2_block

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "int8": torch.int8}


def check_supported(cfg) -> None:
    """The port has the plain dense family and the ssm family; everything
    else says where it stands in the port's queue."""
    if cfg.family not in ("dense", "ssm"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP.md, port "
            f"queue item Q8)")
    if cfg.local_global_alternating or cfg.post_block_norms \
            or cfg.attn_softcap or cfg.logit_softcap:
        raise NotImplementedError(
            "gemma2's alternation, post-norms and softcaps are not ported yet "
            "(ROADMAP.md, port queue item Q8)")


def index_tree(tree, i):
    """Leaf-wise ``leaf[i]`` (one layer of a stacked tree; ``i`` may be a
    slice)."""
    if isinstance(tree, dict):
        return {k: index_tree(v, i) for k, v in tree.items()}
    return tree[i]


def stack_trees(trees):
    """Inverse of indexing every layer: stack per-layer trees on axis 0."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_trees([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


# ---------------------------------------------------------------------------
# Param init and caches
# ---------------------------------------------------------------------------
def init_lm(gen: torch.Generator, cfg,
            device: Optional[torch.device] = None) -> dict:
    check_supported(cfg)
    dt = TORCH_DTYPES[cfg.dtype]
    d, n = cfg.d_model, cfg.n_layers
    params = {"embed": embed_init(gen, cfg.vocab_size, d, dt, device),
              "final_norm": torch.ones(d, dtype=dt, device=device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (d, cfg.vocab_size), dt,
                                       fan_in=d, device=device)
    if cfg.family == "ssm":
        params["layers"] = {
            "ln": torch.ones((n, d), dtype=dt, device=device),
            "mamba": init_mamba2(gen, cfg, dt, lead=(n,), device=device)}
        return params
    params["layers"] = {
        "ln1": torch.ones((n, d), dtype=dt, device=device),
        "attn": init_attention(gen, d, cfg.n_heads, cfg.n_kv_heads,
                               cfg.resolved_head_dim, dt, lead=(n,),
                               qkv_bias=cfg.qkv_bias, device=device),
        "ln2": torch.ones((n, d), dtype=dt, device=device),
        "mlp": {
            "w_gate": dense_init(gen, (n, d, cfg.d_ff), dt, fan_in=d,
                                 device=device),
            "w_up": dense_init(gen, (n, d, cfg.d_ff), dt, fan_in=d,
                               device=device),
            "w_down": dense_init(gen, (n, cfg.d_ff, d), dt, fan_in=cfg.d_ff,
                                 device=device),
        },
    }
    return params


def init_cache(cfg, batch: int, max_len: int,
               device: Optional[torch.device] = None) -> dict:
    check_supported(cfg)
    if cfg.family == "ssm":          # O(1) state: max_len plays no part
        one = make_ssm_cache(batch, cfg, TORCH_DTYPES[cfg.dtype], device)
    else:
        one = make_kv_cache(batch, max_len, cfg.n_kv_heads,
                            cfg.resolved_head_dim,
                            TORCH_DTYPES[cfg.kv_cache_dtype], device)
    return {k: v.expand(cfg.n_layers, *v.shape).clone()
            for k, v in one.items()}


# ---------------------------------------------------------------------------
# Layer body
# ---------------------------------------------------------------------------
def dense_body(lp: dict, x: torch.Tensor, cfg, positions: torch.Tensor,
               cache: Optional[dict]) -> tuple:
    """One dense layer: ``x + attn(ln1(x))`` then ``+ mlp(ln2(.))``. The
    residual add and ln2 run as one fused kernel."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps, plus_one=cfg.embed_scale)
    a, new_cache = attention_block(
        lp["attn"], h, positions=positions, rope_theta=cfg.rope_theta,
        scale=cfg.resolved_head_dim ** -0.5, cache=cache)
    h, x = rmsnorm_residual(x, a, lp["ln2"], eps=cfg.norm_eps,
                            plus_one=cfg.embed_scale)
    return x + gated_mlp(lp["mlp"], h, cfg.mlp_act), new_cache


def ssm_body(lp: dict, x: torch.Tensor, cfg, positions: torch.Tensor,
             cache: Optional[dict]) -> tuple:
    """One Mamba2 layer: ``x + mamba2(ln(x))`` (positions play no part)."""
    h = rms_norm(x, lp["ln"], cfg.norm_eps)
    y, new_cache = mamba2_block(lp["mamba"], h, cfg=cfg, cache=cache)
    return x + y, new_cache


def run_layers(layers: dict, x: torch.Tensor, cfg, positions: torch.Tensor,
               cache: Optional[dict]) -> Tuple[torch.Tensor, Optional[dict]]:
    """The reference's layer scan as a loop over the stacked axis."""
    body = ssm_body if cfg.family == "ssm" else dense_body
    n = layers["ln" if cfg.family == "ssm" else "ln1"].shape[0]
    new_caches = []
    for li in range(n):
        ca = None if cache is None else index_tree(cache, li)
        x, nc = body(index_tree(layers, li), x, cfg, positions, ca)
        new_caches.append(nc)
    if cache is None:
        return x, None
    if not new_caches:
        return x, cache
    return x, stack_trees(new_caches)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------
def embed(params: dict, cfg, tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"][tokens.long()]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def logits(params: dict, cfg, h: torch.Tensor) -> torch.Tensor:
    h = rms_norm(h, params["final_norm"], cfg.norm_eps,
                 plus_one=cfg.embed_scale)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return h @ w


def forward(params: dict, cfg, tokens: torch.Tensor, *,
            cache: Optional[dict] = None,
            positions: Optional[torch.Tensor] = None):
    """Returns (logits, new_cache | None). cache=None: plain forward; a
    cache: prefill (S > 1) or decode (S == 1) at the cache's length."""
    check_supported(cfg)
    x = embed(params, cfg, tokens)
    sq = x.shape[1]
    if positions is None:
        ar = torch.arange(sq, dtype=torch.int32, device=x.device)
        positions = ar if cache is None else cache["length"][0] + ar
    x, new_cache = run_layers(params["layers"], x, cfg, positions, cache)
    return logits(params, cfg, x), new_cache
