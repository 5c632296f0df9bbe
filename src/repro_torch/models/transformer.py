"""Decoder-only LM assembly for every LM family.

Counterpart of src/repro/models/transformer.py:

- dense, vlm : ``[attn, mlp] x L``; gemma2 (``local_global_alternating``)
  as ``[(local attn, mlp), (global attn, mlp)] x L/2`` with its sliding
  window on the local layers (whose cache is a ring of ``min(max_len,
  window)`` slots), attention and final-logit softcaps, post-block norms
  and ``(1 + w)`` norms; the vlm family takes precomputed embeddings
  (``forward(..., embeds=)``) in place of tokens;
- moe    : ``[attn | mla, moe] x L`` after optional leading dense layers
  (deepseek-v2's MLA attention in both);
- ssm    : ``[mamba2] x L``;
- hybrid : ``[mamba2] x L`` with one weight-tied attention block over
  ``concat(x, x0)`` after every ``attn_every``-th layer (zamba2), each
  application with its own KV cache.

Layers are stacked on a leading ``[L, ...]`` axis as in the reference; the
reference's ``lax.scan`` over them becomes a loop over that axis (its
``lax.cond`` for the hybrid's shared block a Python ``if``), and the
stacked cache is rebuilt from the per-layer caches the loop returns.

With ``dist`` (``ShardingRules.dist_ctx()`` plus ``"param_specs"``) the
forward is one rank's program on its shards: a layer's weights gathered
over the FSDP axes where the rules shard them there (inside the layer, so
remat regathers them), the embedding and logits split over the vocabulary,
attention over heads, MLPs over their ffn axis, the experts through
``moe_ep``; ``ActConstraint`` sits where the reference puts it. With
``dist["seq_shard"]`` (sequence parallelism, the reference's train cells)
and a sequence that splits over the model axis, the hidden states between
the blocks are this rank's rows ``[B, S/tp, d]``: the norms run on them,
each block gathers the sequence on entry and leaves with its rows
(``parallel.sharding.Region``), the embedding ends in a reduce-scatter and
the head gathers the sequence back.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..kernels.rmsnorm import rmsnorm_residual
from ..parallel.sharding import (ActConstraint, Region, index_specs,
                                 seq_dist, tp_if)
from .attention import attention_block, init_attention, make_kv_cache
from .layers import (dense_init, embed_init, gated_mlp, init_gated_mlp,
                     rms_norm, softcap)
from .mamba2 import init_mamba2, make_ssm_cache, mamba2_block
from .mla import init_mla, make_mla_cache, mla_block
from .moe import init_moe, moe_capacity, moe_dense_oracle, moe_ep

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "int8": torch.int8}
LM_FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid")


def _unknown(cfg) -> ValueError:
    return ValueError(f"the LM assembly does not handle family "
                      f"{cfg.family!r}")


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
    """A layer's two norms and its attention (MLA where the config says)."""
    d = cfg.d_model
    if cfg.use_mla:
        attn = init_mla(gen, cfg, dt, lead=lead, device=device)
    else:
        attn = init_attention(gen, d, cfg.n_heads, cfg.n_kv_heads,
                              cfg.resolved_head_dim, dt, lead=lead,
                              qkv_bias=cfg.qkv_bias, device=device)
    return {
        "ln1": torch.ones(lead + (d,), dtype=dt, device=device),
        "attn": attn,
        "ln2": torch.ones(lead + (d,), dtype=dt, device=device),
    }


def _init_dense_layers(gen, cfg, dt, lead, device) -> dict:
    p = _init_attn_norms(gen, cfg, dt, lead, device)
    p["mlp"] = init_gated_mlp(gen, cfg.d_model, cfg.d_ff, dt, lead=lead,
                              device=device)
    if cfg.post_block_norms:
        for name in ("ln1_post", "ln2_post"):
            p[name] = torch.ones(lead + (cfg.d_model,), dtype=dt,
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
    dt = TORCH_DTYPES[cfg.dtype]
    d, n = cfg.d_model, cfg.n_layers
    if cfg.family not in LM_FAMILIES:
        raise _unknown(cfg)
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
            # deepseek's leading dense layers: MLA (where the config has
            # it) and a plain gated MLP
            params["dense_layers"] = [
                _init_dense_layers(gen, cfg, dt, (), device)
                for _ in range(cfg.n_dense_layers)]
        n_moe = n - cfg.n_dense_layers
        layers = _init_attn_norms(gen, cfg, dt, (n_moe,), device)
        layers["moe"] = init_moe(gen, d, moe_padded_experts(cfg),
                                 cfg.moe_d_ff, cfg.shared_d_ff, dt,
                                 lead=(n_moe,), device=device)
        params["layers"] = layers
    elif cfg.local_global_alternating:
        nb = n // 2                   # one (local, global) pair a block
        params["layers"] = {
            "local": _init_dense_layers(gen, cfg, dt, (nb,), device),
            "global": _init_dense_layers(gen, cfg, dt, (nb,), device)}
    else:
        params["layers"] = _init_dense_layers(gen, cfg, dt, (n,), device)
    return params


def _stack(one: dict, n: int) -> dict:
    return {k: v.expand(n, *v.shape).clone() for k, v in one.items()}


def init_cache(cfg, batch: int, max_len: int,
               device: Optional[torch.device] = None) -> dict:
    kvd = TORCH_DTYPES[cfg.kv_cache_dtype]

    def kv(length=max_len):
        return make_kv_cache(batch, length, cfg.n_kv_heads,
                             cfg.resolved_head_dim, kvd, device)

    def ssm():          # O(1) state: max_len plays no part
        return make_ssm_cache(batch, cfg, TORCH_DTYPES[cfg.dtype], device)

    if cfg.family == "ssm":
        return _stack(ssm(), cfg.n_layers)
    if cfg.family == "hybrid":
        return {"mamba": _stack(ssm(), cfg.n_layers),
                "attn": _stack(kv(), cfg.n_layers // cfg.attn_every)}
    if cfg.family == "moe":
        one = ((lambda: make_mla_cache(batch, max_len, cfg, kvd, device))
               if cfg.use_mla else kv)
        out = {"layers": _stack(one(), cfg.n_layers - cfg.n_dense_layers)}
        if cfg.n_dense_layers:
            out["dense_layers"] = [one() for _ in range(cfg.n_dense_layers)]
        return out
    if cfg.family not in LM_FAMILIES:
        raise _unknown(cfg)
    if cfg.local_global_alternating:
        nb = cfg.n_layers // 2
        local = (min(max_len, cfg.sliding_window) if cfg.sliding_window
                 else max_len)            # a ring: slot = position % local
        return {"local": _stack(kv(local), nb), "global": _stack(kv(), nb)}
    return _stack(kv(), cfg.n_layers)


def cache_length(cfg, cache: dict) -> torch.Tensor:
    """Tokens already in ``cache`` (0-d)."""
    if cfg.family == "moe":
        return cache["layers"]["length"][0]
    if cfg.family == "hybrid":
        return cache["mamba"]["length"][0]
    if cfg.local_global_alternating:
        return cache["global"]["length"][0]
    return cache["length"][0]


# ---------------------------------------------------------------------------
# Layer bodies
# ---------------------------------------------------------------------------
def fsdp_gather(tree, dist: Optional[dict], specs):
    """``tree``'s leaves gathered over the FSDP axes where ``specs`` shard
    them there; ``tree`` itself without ``dist`` or specs. Under
    ``mlp_fsdp`` a gated MLP's weights are gathered over the model axis
    too: every rank computes that MLP whole."""
    if not dist or specs is None or dist.get("spmd") is None:
        return tree
    spmd, fsdp = dist["spmd"], dist.get("fsdp")
    whole = dist.get("tp") if dist.get("mlp_fsdp") else None

    def walk(t, sp, key=None):
        if whole and key == "mlp" and "w_gate" in t:
            return spmd.gather_tree(t, sp, fsdp, whole=whole)
        if isinstance(t, dict):
            return {k: walk(v, sp[k], k) for k, v in t.items()}
        return spmd.gather_tree(t, sp, fsdp)
    return walk(tree, specs)


def mlp_region(dist: Optional[dict]) -> Region:
    """A layer's gated MLP: split over its ffn axis where that divides,
    whole on every rank under ``mlp_fsdp`` (the reference's ``ffn``
    constraint)."""
    return Region(dist, not (dist or {}).get("mlp_fsdp") and "dff_tp")


def _cons(dist: Optional[dict]):
    return ActConstraint(dist) if dist else None


def _hidden(cons, x):
    return x if cons is None else cons.hidden(x)


def _attention(lp: dict, h: torch.Tensor, cfg, positions: torch.Tensor,
               cache: Optional[dict], window: int = 0,
               q_chunk: int = 0, cons=None, dist=None) -> tuple:
    """A layer's attention: MLA where the config has it (deepseek's dense
    and MoE layers), else GQA with the config's softcap and ``window``."""
    if cfg.use_mla:
        return mla_block(lp["attn"], h, cfg=cfg, positions=positions,
                         cache=cache, q_chunk=q_chunk, cons=cons, dist=dist)
    return attention_block(
        lp["attn"], h, positions=positions, rope_theta=cfg.rope_theta,
        window=window, attn_softcap=cfg.attn_softcap,
        scale=cfg.resolved_head_dim ** -0.5, cache=cache, q_chunk=q_chunk,
        cons=cons, dist=dist)


def dense_body(lp: dict, x: torch.Tensor, cfg, positions: torch.Tensor,
               cache: Optional[dict], window: int = 0,
               q_chunk: int = 0, dist: Optional[dict] = None) -> tuple:
    """One dense layer (also the moe family's leading ones): ``x +
    attn(ln1(x))`` then ``+ mlp(ln2(.))``, each branch through its
    post-block norm where the config has them (gemma2). The residual add
    and ln2 run as one fused kernel."""
    cons = _cons(dist)
    h = rms_norm(x, lp["ln1"], cfg.norm_eps, plus_one=cfg.embed_scale)
    a, new_cache = _attention(lp, h, cfg, positions, cache, window, q_chunk,
                              cons, dist)
    if cfg.post_block_norms:
        a = rms_norm(a, lp["ln1_post"], cfg.norm_eps,
                     plus_one=cfg.embed_scale)
    h, x = rmsnorm_residual(x, a, lp["ln2"], eps=cfg.norm_eps,
                            plus_one=cfg.embed_scale)
    x = _hidden(cons, x)
    m = gated_mlp(lp["mlp"], h, cfg.mlp_act, cons, mlp_region(dist))
    if cfg.post_block_norms:
        m = rms_norm(m, lp["ln2_post"], cfg.norm_eps,
                     plus_one=cfg.embed_scale)
    return _hidden(cons, x + m), new_cache


def moe_body(lp: dict, x: torch.Tensor, cfg, positions: torch.Tensor,
             cache: Optional[dict], use_oracle: bool,
             q_chunk: int = 0, dist: Optional[dict] = None) -> tuple:
    """One MoE layer: ``x + attn(ln1(x))`` (MLA where the config has it)
    then ``+ experts(ln2(.))`` (plus the shared experts where the layer has
    them); returns (x, new_cache, aux). The residual add and ln2 run as
    one fused kernel. Where ``dist`` splits the model axis, the experts go
    through ``moe_ep`` (the reference's ``moe_ep_shardmap``)."""
    cons = _cons(dist)
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    a, new_cache = _attention(lp, h, cfg, positions, cache, 0, q_chunk,
                              cons, dist)
    h, x = rmsnorm_residual(x, a, lp["ln2"], eps=cfg.norm_eps)
    x = _hidden(cons, x)
    if tp_if(dist) is not None:
        mo, aux = moe_ep(lp["moe"], h, topk=cfg.n_experts_active, dist=dist,
                         norm_topk=cfg.router_norm_topk, act=cfg.mlp_act,
                         n_valid=cfg.n_experts)
    elif use_oracle:
        mo, aux = moe_dense_oracle(lp["moe"], h, cfg.n_experts_active,
                                   cfg.router_norm_topk, cfg.mlp_act,
                                   cfg.n_experts)
    else:
        mo, aux = moe_capacity(lp["moe"], h, cfg.n_experts_active,
                               norm_topk=cfg.router_norm_topk,
                               act=cfg.mlp_act, n_valid=cfg.n_experts)
    if "shared" in lp["moe"]:
        mo = mo + gated_mlp(lp["moe"]["shared"], h, cfg.mlp_act, cons,
                            Region(dist, "shared_tp"))
    return _hidden(cons, x + mo), new_cache, aux


def ssm_body(lp: dict, x: torch.Tensor, cfg, positions: torch.Tensor,
             cache: Optional[dict], dist: Optional[dict] = None) -> tuple:
    """One Mamba2 layer: ``x + mamba2(ln(x))`` (positions play no part)."""
    cons = _cons(dist)
    h = rms_norm(x, lp["ln"], cfg.norm_eps)
    y, new_cache = mamba2_block(lp["mamba"], h, cfg=cfg, cache=cache,
                                cons=cons, dist=dist)
    return _hidden(cons, x + y), new_cache


def pair_body(lp: dict, x: torch.Tensor, cfg, positions: torch.Tensor,
              cache: Optional[dict], q_chunk: int = 0,
              dist: Optional[dict] = None) -> tuple:
    """One gemma2 block: the local layer (sliding window) then the global
    one, each with its own cache."""
    x, ncl = dense_body(lp["local"], x, cfg, positions,
                        None if cache is None else cache["local"],
                        cfg.sliding_window, q_chunk, dist)
    x, ncg = dense_body(lp["global"], x, cfg, positions,
                        None if cache is None else cache["global"], 0,
                        q_chunk, dist)
    return x, (None if cache is None else {"local": ncl, "global": ncg})


def shared_attn_body(sp: dict, x: torch.Tensor, x0: torch.Tensor, cfg,
                     positions: torch.Tensor, cache: Optional[dict],
                     q_chunk: int = 0, dist: Optional[dict] = None) -> tuple:
    """zamba2's shared block on ``concat(x, x0)``, ``x0`` the embedded
    input: ``x + attn(ln1(cat))`` then ``+ mlp(ln2(.))``."""
    cons = _cons(dist)
    h = rms_norm(torch.cat([x, x0], dim=-1), sp["ln1"], cfg.norm_eps)
    a, new_cache = attention_block(
        sp["attn"], h, positions=positions, rope_theta=cfg.rope_theta,
        scale=cfg.resolved_head_dim ** -0.5, cache=cache, q_chunk=q_chunk,
        cons=cons, dist=dist)
    h, x = rmsnorm_residual(x, a, sp["ln2"], eps=cfg.norm_eps)
    x = _hidden(cons, x)
    return x + gated_mlp(sp["mlp"], h, cfg.mlp_act, cons,
                         mlp_region(dist)), new_cache


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


REMAT_MODES = ("none", "full", "dots")
_WEIGHT_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_weight_products():
    """Selective checkpointing's contexts for ``remat="dots"``: keep the
    outputs of the weight products (``mm``/``addmm``: the reference's
    ``dots_with_no_batch_dims_saveable``) and recompute everything else."""
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in _WEIGHT_PRODUCTS
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return create_selective_checkpoint_contexts(policy)


def maybe_remat(fn, remat: str):
    """A layer body under the reference's remat policy (``_maybe_remat``):
    ``"none"`` as it is; ``"full"`` recomputed whole in the backward
    (``torch.utils.checkpoint``, non-reentrant); ``"dots"`` the same
    keeping the weight products' outputs."""
    if remat not in REMAT_MODES:
        raise ValueError(f"remat must be one of {REMAT_MODES}, got {remat!r}")
    if remat == "none":
        return fn
    from torch.utils.checkpoint import checkpoint
    kw = {"context_fn": _save_weight_products} if remat == "dots" else {}

    def body(*args):
        return checkpoint(fn, *args, use_reentrant=False, **kw)
    return body


def layer_body(lp: dict, x: torch.Tensor, cfg, positions: torch.Tensor,
               cache: Optional[dict], moe_oracle: bool = False,
               q_chunk: int = 0, dist: Optional[dict] = None,
               specs=None) -> tuple:
    """One layer of the stack (a gemma2 pair counts as one): (x, new_cache,
    aux), aux None but for the moe family. Under ``dist`` its weights are
    first gathered over the FSDP axes (``specs``: the layer's specs)."""
    lp = fsdp_gather(lp, dist, specs)
    if cfg.family == "ssm":
        return (*ssm_body(lp, x, cfg, positions, cache, dist), None)
    if cfg.family == "moe":
        return moe_body(lp, x, cfg, positions, cache, moe_oracle, q_chunk,
                        dist)
    body = pair_body if cfg.local_global_alternating else dense_body
    return (*body(lp, x, cfg, positions, cache, q_chunk=q_chunk,
                  dist=dist), None)


def _specs(dist: Optional[dict], *path):
    """The param specs at ``path`` in ``dist["param_specs"]`` (None when
    there are none)."""
    specs = (dist or {}).get("param_specs")
    for k in path:
        if specs is None:
            return None
        specs = specs[k]
    return specs


def run_layers(layers: dict, x: torch.Tensor, cfg, positions: torch.Tensor,
               cache: Optional[dict], *, moe_oracle: bool = False,
               remat: str = "none", q_chunk: int = 0,
               dist: Optional[dict] = None, specs=None
               ) -> Tuple[torch.Tensor, Optional[dict], torch.Tensor]:
    """The reference's layer scan as a loop over the stacked axis (dense,
    gemma2 pairs, ssm and moe layers; ``moe_oracle`` picks the moe layers'
    expert path), each layer under ``remat``. Returns (x, new_cache | None,
    aux): the moe layers' aux losses summed in f32 (0 for the others).
    ``specs``: the stacked layers' param specs (under ``dist``)."""
    body = maybe_remat(layer_body, remat)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches = []
    lspecs = None if specs is None else index_specs(specs)
    for li in range(_first_leaf(layers).shape[0]):
        ca = None if cache is None else index_tree(cache, li)
        x, nc, a = body(index_tree(layers, li), x, cfg, positions, ca,
                        moe_oracle, q_chunk, dist, lspecs)
        if a is not None:
            aux = aux + a.float()
        new_caches.append(nc)
    if cache is None:
        return x, None, aux
    if not new_caches:
        return x, cache, aux
    return x, stack_trees(new_caches), aux


def hybrid_layer(lp: dict, x: torch.Tensor, cfg, positions: torch.Tensor,
                 cache: Optional[dict], shared: Optional[tuple],
                 q_chunk: int = 0, dist: Optional[dict] = None,
                 specs=None) -> tuple:
    """One Mamba2 layer and, where ``shared`` is ``(sp, x0, attn_cache)``,
    the shared block after it: (x, new_cache, new_attn_cache | None).
    ``specs``: (the layer's, the shared block's) param specs (under
    ``dist``)."""
    lspecs, sspecs = specs if specs is not None else (None, None)
    x, nc = ssm_body(fsdp_gather(lp, dist, lspecs), x, cfg, positions,
                     cache, dist)
    if shared is None:
        return x, nc, None
    sp, x0, attn_cache = shared
    x, na = shared_attn_body(fsdp_gather(sp, dist, sspecs), x, x0, cfg,
                             positions, attn_cache, q_chunk, dist)
    return x, nc, na


def run_hybrid(params: dict, x: torch.Tensor, cfg, positions: torch.Tensor,
               cache: Optional[dict], *, remat: str = "none",
               q_chunk: int = 0, dist: Optional[dict] = None
               ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Mamba2 layers with the shared block after layer ``li`` where ``li %
    attn_every == attn_every - 1``, application ``min(li // attn_every,
    n_apps - 1)`` with its own KV cache; each layer (with the shared block
    after it) under ``remat``, as the reference's scan body."""
    every = cfg.attn_every
    n_apps = cfg.n_layers // every
    x0 = x
    layers = params["layers"]
    body = maybe_remat(hybrid_layer, remat)
    attn = (None if cache is None else
            [index_tree(cache["attn"], j) for j in range(n_apps)])
    mamba = []
    specs = None
    if _specs(dist, "layers") is not None:
        specs = (index_specs(_specs(dist, "layers")),
                 _specs(dist, "shared_attn"))
    for li in range(layers["ln"].shape[0]):
        ca = None if cache is None else index_tree(cache["mamba"], li)
        j = min(li // every, n_apps - 1)
        shared = None
        if li % every == every - 1:
            shared = (params["shared_attn"], x0,
                      None if attn is None else attn[j])
        x, nc, na = body(index_tree(layers, li), x, cfg, positions, ca,
                         shared, q_chunk, dist, specs)
        mamba.append(nc)
        if na is not None:
            attn[j] = na
    if cache is None:
        return x, None
    return x, {"mamba": stack_trees(mamba) if mamba else cache["mamba"],
               "attn": stack_trees(attn) if attn else cache["attn"]}


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------
def lookup(table: torch.Tensor, tokens: torch.Tensor, vocab: int,
           dist: Optional[dict] = None) -> torch.Tensor:
    """``table[tokens]``; where ``dist`` split the table's vocabulary over
    the model axis (fewer rows than ``vocab``), each rank looks up the
    tokens of its rows and the ranks sum (a reduce-scatter onto this
    rank's rows under sequence parallelism)."""
    reg = Region(dist, table.shape[0] != vocab)
    if not reg.split:
        return reg.leave(table[tokens.long()])
    v_loc = table.shape[0]
    ids = tokens.long() - reg.spmd.rank(reg.tp) * v_loc
    mine = (ids >= 0) & (ids < v_loc)
    x = table[ids.clamp(0, v_loc - 1)] * mine[..., None].to(table.dtype)
    return reg.leave(x)


def project_vocab(h: torch.Tensor, w: torch.Tensor, vocab: int,
                  dist: Optional[dict] = None) -> torch.Tensor:
    """``h @ w``; where ``w`` [d, V] is this rank's vocabulary slice the
    logits stay split over the model axis (the reference's
    ``logits_spec``). Under sequence parallelism ``h`` is this rank's rows
    and the logits cover the whole sequence."""
    return Region(dist, w.shape[-1] != vocab).enter(h) @ w


# the LM's top-level parameter keys whose row leaves run on this rank's
# sequence shard under sequence parallelism (``sharding.seq_row_leaf``)
LM_ROOTS = ("layers", "dense_layers", "shared_attn", "final_norm")


def embed(params: dict, cfg, tokens: Optional[torch.Tensor] = None,
          embeds: Optional[torch.Tensor] = None,
          dist: Optional[dict] = None) -> torch.Tensor:
    """Token embeddings, or the given ``embeds``; gemma2 scales them by
    sqrt(d) cast to their dtype first, as the reference does. Under
    sequence parallelism, this rank's rows."""
    x = (lookup(params["embed"], tokens, cfg.vocab_size, dist)
         if embeds is None else Region(dist).leave(embeds, summed=False))
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def logits(params: dict, cfg, h: torch.Tensor,
           dist: Optional[dict] = None) -> torch.Tensor:
    h = rms_norm(h, params["final_norm"], cfg.norm_eps,
                 plus_one=cfg.embed_scale)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    out = project_vocab(h, w, cfg.vocab_size, dist)
    if cfg.logit_softcap > 0:
        out = softcap(out, cfg.logit_softcap)
    return out if dist is None else ActConstraint(dist).logits(out)


def forward(params: dict, cfg, tokens: Optional[torch.Tensor] = None, *,
            embeds: Optional[torch.Tensor] = None,
            cache: Optional[dict] = None,
            positions: Optional[torch.Tensor] = None,
            moe_oracle: Optional[bool] = None, q_chunk: int = 0,
            remat: str = "none", with_aux: bool = False,
            dist: Optional[dict] = None):
    """Returns (logits, new_cache | None), and the moe layers' summed aux
    loss (f32, 0 for the other families) after them when ``with_aux``.
    cache=None: plain forward (training); a cache: prefill (S > 1) or
    decode (S == 1) at the cache's length. ``embeds`` [B, S, d] stand in
    for the tokens' embeddings (the vlm family's image and token
    embeddings). ``moe_oracle`` picks the moe layers' expert path (default:
    the dense oracle up to 16 experts, the capacity path above);
    ``q_chunk`` blocks the attention's plain queries; ``remat`` ("none",
    "full", "dots") recomputes each layer of the stack in the backward, as
    the reference's scan body (deepseek's leading dense layers, outside
    the scan there, are not). ``dist``: run as one rank of a mesh on its
    shards (module docstring)."""
    if cfg.family not in LM_FAMILIES:
        raise _unknown(cfg)
    sq = (tokens if embeds is None else embeds).shape[1]
    dist = seq_dist(dist, sq, LM_ROOTS)
    x = _hidden(_cons(dist), embed(params, cfg, tokens, embeds, dist))
    if positions is None:
        ar = torch.arange(sq, dtype=torch.int32, device=x.device)
        positions = ar if cache is None else cache_length(cfg, cache) + ar
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "hybrid":
        x, new_cache = run_hybrid(params, x, cfg, positions, cache,
                                  remat=remat, q_chunk=q_chunk, dist=dist)
    elif cfg.family == "moe":
        if moe_oracle is None:
            moe_oracle = default_moe_oracle(cfg)
        dense = []
        for i in range(cfg.n_dense_layers):
            lp = fsdp_gather(params["dense_layers"][i], dist,
                             _specs(dist, "dense_layers", i))
            x, nc = dense_body(lp, x, cfg, positions,
                               None if cache is None
                               else cache["dense_layers"][i], 0, q_chunk,
                               dist)
            dense.append(nc)
        x, layer_cache, aux = run_layers(
            params["layers"], x, cfg, positions,
            None if cache is None else cache["layers"],
            moe_oracle=moe_oracle, remat=remat, q_chunk=q_chunk, dist=dist,
            specs=_specs(dist, "layers"))
        new_cache = None
        if cache is not None:
            new_cache = {"layers": layer_cache}
            if dense:
                new_cache["dense_layers"] = dense
    else:
        x, new_cache, aux = run_layers(params["layers"], x, cfg, positions,
                                       cache, remat=remat, q_chunk=q_chunk,
                                       dist=dist,
                                       specs=_specs(dist, "layers"))
    out = logits(params, cfg, x, dist)
    return (out, new_cache, aux) if with_aux else (out, new_cache)
