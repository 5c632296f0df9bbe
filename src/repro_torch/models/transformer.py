"""Decoder-only LM assembly: the dense, ssm, hybrid and moe families.

Counterpart of src/repro/models/transformer.py:

- dense  : ``[attn, mlp] x L`` (without gemma2's local/global alternation
  or post-norms);
- moe    : ``[attn, moe] x L`` after optional leading dense layers (not
  with MLA attention);
- ssm    : ``[mamba2] x L``;
- hybrid : ``[mamba2] x L`` with one weight-tied attention block over
  ``concat(x, x0)`` after every ``attn_every``-th layer (zamba2), each
  application with its own KV cache.

Layers are stacked on a leading ``[L, ...]`` axis as in the reference; the
reference's ``lax.scan`` over them becomes a loop over that axis (its
``lax.cond`` for the hybrid's shared block a Python ``if``), and the
stacked cache is rebuilt from the per-layer caches the loop returns.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..kernels.rmsnorm import rmsnorm_residual
from .attention import attention_block, init_attention, make_kv_cache
from .layers import dense_init, embed_init, gated_mlp, init_gated_mlp, rms_norm
from .mamba2 import init_mamba2, make_ssm_cache, mamba2_block
from .moe import init_moe, moe_capacity, moe_dense_oracle

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "int8": torch.int8}

# what the port still refuses, and the ROADMAP.md item that will port it
_NOT_PORTED = {"encdec": "Q8.4", "vlm": "Q8.5"}


def check_supported(cfg) -> None:
    """The port has the dense, moe, ssm and hybrid families; everything
    else says where it stands in the port's queue."""
    if cfg.family not in ("dense", "moe", "ssm", "hybrid"):
        item = _NOT_PORTED.get(cfg.family, "Q8")
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP.md, port "
            f"queue item {item})")
    if cfg.use_mla:
        raise NotImplementedError(
            "MLA attention (deepseek-v2) is not ported yet (ROADMAP.md, port "
            "queue item Q8.3)")
    if cfg.local_global_alternating or cfg.post_block_norms \
            or cfg.attn_softcap or cfg.logit_softcap:
        raise NotImplementedError(
            "gemma2's alternation, post-norms and softcaps are not ported yet "
            "(ROADMAP.md, port queue item Q8.6)")


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


def moe_padded_experts(cfg) -> int:
    """The expert count padded to a multiple of the expert-parallel shard
    width (qwen2-moe 60 -> 64 at ``ep_shards`` 16); the padding experts are
    masked from routing."""
    e, w = cfg.n_experts, max(cfg.ep_shards, 1)
    return e if e % w == 0 else e + (w - e % w)


def default_moe_oracle(cfg) -> bool:
    """The reference's default expert path: the dense oracle up to 16
    experts, the capacity path above."""
    return 0 < cfg.n_experts <= 16


# ---------------------------------------------------------------------------
# Param init and caches
# ---------------------------------------------------------------------------
def _init_attn_norms(gen, cfg, dt, lead, device) -> dict:
    """A layer's two norms and its attention (a dense or moe layer)."""
    d = cfg.d_model
    return {
        "ln1": torch.ones(lead + (d,), dtype=dt, device=device),
        "attn": init_attention(gen, d, cfg.n_heads, cfg.n_kv_heads,
                               cfg.resolved_head_dim, dt, lead=lead,
                               qkv_bias=cfg.qkv_bias, device=device),
        "ln2": torch.ones(lead + (d,), dtype=dt, device=device),
    }


def _init_dense_layers(gen, cfg, dt, lead, device) -> dict:
    p = _init_attn_norms(gen, cfg, dt, lead, device)
    p["mlp"] = init_gated_mlp(gen, cfg.d_model, cfg.d_ff, dt, lead=lead,
                              device=device)
    return p


def _init_shared_attn(gen, cfg, dt, device) -> dict:
    """zamba2's weight-tied block: attention over ``concat(x, x0)`` [2d],
    its output projected straight back to d."""
    d = cfg.d_model
    return {
        "ln1": torch.ones(2 * d, dtype=dt, device=device),
        "attn": init_attention(gen, 2 * d, cfg.n_heads, cfg.n_kv_heads,
                               cfg.resolved_head_dim, dt, d_out=d,
                               device=device),
        "ln2": torch.ones(d, dtype=dt, device=device),
        "mlp": init_gated_mlp(gen, d, cfg.d_ff, dt, device=device),
    }


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
    if cfg.family in ("ssm", "hybrid"):
        params["layers"] = {
            "ln": torch.ones((n, d), dtype=dt, device=device),
            "mamba": init_mamba2(gen, cfg, dt, lead=(n,), device=device)}
        if cfg.family == "hybrid":
            params["shared_attn"] = _init_shared_attn(gen, cfg, dt, device)
    elif cfg.family == "moe":
        if cfg.n_dense_layers:
            params["dense_layers"] = [
                _init_dense_layers(gen, cfg, dt, (), device)
                for _ in range(cfg.n_dense_layers)]
        n_moe = n - cfg.n_dense_layers
        layers = _init_attn_norms(gen, cfg, dt, (n_moe,), device)
        layers["moe"] = init_moe(gen, d, moe_padded_experts(cfg),
                                 cfg.moe_d_ff, cfg.shared_d_ff, dt,
                                 lead=(n_moe,), device=device)
        params["layers"] = layers
    else:
        params["layers"] = _init_dense_layers(gen, cfg, dt, (n,), device)
    return params


def _stack(one: dict, n: int) -> dict:
    return {k: v.expand(n, *v.shape).clone() for k, v in one.items()}


def init_cache(cfg, batch: int, max_len: int,
               device: Optional[torch.device] = None) -> dict:
    check_supported(cfg)

    def kv():
        return make_kv_cache(batch, max_len, cfg.n_kv_heads,
                             cfg.resolved_head_dim,
                             TORCH_DTYPES[cfg.kv_cache_dtype], device)

    def ssm():          # O(1) state: max_len plays no part
        return make_ssm_cache(batch, cfg, TORCH_DTYPES[cfg.dtype], device)

    if cfg.family == "ssm":
        return _stack(ssm(), cfg.n_layers)
    if cfg.family == "hybrid":
        return {"mamba": _stack(ssm(), cfg.n_layers),
                "attn": _stack(kv(), cfg.n_layers // cfg.attn_every)}
    if cfg.family == "moe":
        out = {"layers": _stack(kv(), cfg.n_layers - cfg.n_dense_layers)}
        if cfg.n_dense_layers:
            out["dense_layers"] = [kv() for _ in range(cfg.n_dense_layers)]
        return out
    return _stack(kv(), cfg.n_layers)


def cache_length(cfg, cache: dict) -> torch.Tensor:
    """Tokens already in ``cache`` (0-d)."""
    if cfg.family == "moe":
        return cache["layers"]["length"][0]
    if cfg.family == "hybrid":
        return cache["mamba"]["length"][0]
    return cache["length"][0]


# ---------------------------------------------------------------------------
# Layer bodies
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


def moe_body(lp: dict, x: torch.Tensor, cfg, positions: torch.Tensor,
             cache: Optional[dict], use_oracle: bool) -> tuple:
    """One MoE layer: ``x + attn(ln1(x))`` then ``+ experts(ln2(.))`` (plus
    the shared experts where the layer has them); returns (x, new_cache,
    aux). The residual add and ln2 run as one fused kernel."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    a, new_cache = attention_block(
        lp["attn"], h, positions=positions, rope_theta=cfg.rope_theta,
        scale=cfg.resolved_head_dim ** -0.5, cache=cache)
    h, x = rmsnorm_residual(x, a, lp["ln2"], eps=cfg.norm_eps)
    if use_oracle:
        mo, aux = moe_dense_oracle(lp["moe"], h, cfg.n_experts_active,
                                   cfg.router_norm_topk, cfg.mlp_act,
                                   cfg.n_experts)
    else:
        mo, aux = moe_capacity(lp["moe"], h, cfg.n_experts_active,
                               norm_topk=cfg.router_norm_topk,
                               act=cfg.mlp_act, n_valid=cfg.n_experts)
    if "shared" in lp["moe"]:
        mo = mo + gated_mlp(lp["moe"]["shared"], h, cfg.mlp_act)
    return x + mo, new_cache, aux


def ssm_body(lp: dict, x: torch.Tensor, cfg, positions: torch.Tensor,
             cache: Optional[dict]) -> tuple:
    """One Mamba2 layer: ``x + mamba2(ln(x))`` (positions play no part)."""
    h = rms_norm(x, lp["ln"], cfg.norm_eps)
    y, new_cache = mamba2_block(lp["mamba"], h, cfg=cfg, cache=cache)
    return x + y, new_cache


def shared_attn_body(sp: dict, x: torch.Tensor, x0: torch.Tensor, cfg,
                     positions: torch.Tensor, cache: Optional[dict]) -> tuple:
    """zamba2's shared block on ``concat(x, x0)``, ``x0`` the embedded
    input: ``x + attn(ln1(cat))`` then ``+ mlp(ln2(.))``."""
    h = rms_norm(torch.cat([x, x0], dim=-1), sp["ln1"], cfg.norm_eps)
    a, new_cache = attention_block(
        sp["attn"], h, positions=positions, rope_theta=cfg.rope_theta,
        scale=cfg.resolved_head_dim ** -0.5, cache=cache)
    h, x = rmsnorm_residual(x, a, sp["ln2"], eps=cfg.norm_eps)
    return x + gated_mlp(sp["mlp"], h, cfg.mlp_act), new_cache


def run_layers(layers: dict, x: torch.Tensor, cfg, positions: torch.Tensor,
               cache: Optional[dict], *, moe_oracle: bool = False
               ) -> Tuple[torch.Tensor, Optional[dict]]:
    """The reference's layer scan as a loop over the stacked axis (dense,
    ssm and moe layers; ``moe_oracle`` picks the moe layers' expert
    path)."""
    n = layers["ln" if cfg.family == "ssm" else "ln1"].shape[0]
    new_caches = []
    for li in range(n):
        lp = index_tree(layers, li)
        ca = None if cache is None else index_tree(cache, li)
        if cfg.family == "ssm":
            x, nc = ssm_body(lp, x, cfg, positions, ca)
        elif cfg.family == "moe":
            x, nc, _ = moe_body(lp, x, cfg, positions, ca, moe_oracle)
        else:
            x, nc = dense_body(lp, x, cfg, positions, ca)
        new_caches.append(nc)
    if cache is None:
        return x, None
    if not new_caches:
        return x, cache
    return x, stack_trees(new_caches)


def run_hybrid(params: dict, x: torch.Tensor, cfg, positions: torch.Tensor,
               cache: Optional[dict]) -> Tuple[torch.Tensor, Optional[dict]]:
    """Mamba2 layers with the shared block after layer ``li`` where ``li %
    attn_every == attn_every - 1``, application ``min(li // attn_every,
    n_apps - 1)`` with its own KV cache."""
    every = cfg.attn_every
    n_apps = cfg.n_layers // every
    x0 = x
    layers = params["layers"]
    attn = (None if cache is None else
            [index_tree(cache["attn"], j) for j in range(n_apps)])
    mamba = []
    for li in range(layers["ln"].shape[0]):
        ca = None if cache is None else index_tree(cache["mamba"], li)
        x, nc = ssm_body(index_tree(layers, li), x, cfg, positions, ca)
        mamba.append(nc)
        if li % every == every - 1:
            j = min(li // every, n_apps - 1)
            x, nc = shared_attn_body(params["shared_attn"], x, x0, cfg,
                                     positions,
                                     None if attn is None else attn[j])
            if attn is not None:
                attn[j] = nc
    if cache is None:
        return x, None
    return x, {"mamba": stack_trees(mamba) if mamba else cache["mamba"],
               "attn": stack_trees(attn) if attn else cache["attn"]}


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
            positions: Optional[torch.Tensor] = None,
            moe_oracle: Optional[bool] = None):
    """Returns (logits, new_cache | None). cache=None: plain forward; a
    cache: prefill (S > 1) or decode (S == 1) at the cache's length.
    ``moe_oracle`` picks the moe layers' expert path (default: the dense
    oracle up to 16 experts, the capacity path above)."""
    check_supported(cfg)
    x = embed(params, cfg, tokens)
    sq = x.shape[1]
    if positions is None:
        ar = torch.arange(sq, dtype=torch.int32, device=x.device)
        positions = ar if cache is None else cache_length(cfg, cache) + ar
    if cfg.family == "hybrid":
        x, new_cache = run_hybrid(params, x, cfg, positions, cache)
    elif cfg.family == "moe":
        if moe_oracle is None:
            moe_oracle = default_moe_oracle(cfg)
        dense = []
        for i in range(cfg.n_dense_layers):
            x, nc = dense_body(params["dense_layers"][i], x, cfg, positions,
                               None if cache is None
                               else cache["dense_layers"][i])
            dense.append(nc)
        x, layer_cache = run_layers(
            params["layers"], x, cfg, positions,
            None if cache is None else cache["layers"],
            moe_oracle=moe_oracle)
        new_cache = None
        if cache is not None:
            new_cache = {"layers": layer_cache}
            if dense:
                new_cache["dense_layers"] = dense
    else:
        x, new_cache = run_layers(params["layers"], x, cfg, positions, cache)
    return logits(params, cfg, x), new_cache
