"""Mixture-of-Experts: router and two expert-compute paths.

Counterpart of src/repro/models/moe.py on one device:

* ``moe_dense_oracle``: every expert over every token, weighted by the
  sparse gate matrix. Exact (no capacity drops); the staged decode path
  and the reference's small configs use it.
* ``moe_capacity``: gather, batched expert products, combine, with a fixed
  per-expert capacity; pairs past an expert's capacity are dropped, as in
  the reference. It dispatches over all the experts on one device; the
  reference's expert-slice arguments serve its mesh version
  (``moe_ep_shardmap``), which is not ported yet (ROADMAP.md, Q10).

Parameters keep the reference layout: ``router [d, E]``, ``experts
{"w_gate", "w_up": [E, d, f], "w_down": [E, f, d]}``, optional ``shared``
gated-MLP parameters. The expert products are plain batched products
(``matmul``/``bmm``), as the reference's einsums are no Pallas kernel
either. Both
paths return ``(out, aux)``, ``aux`` being the Switch load-balance loss.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .layers import act_fn, dense_init, init_gated_mlp


def init_moe(gen: torch.Generator, d: int, n_experts: int, moe_d_ff: int,
             shared_d_ff: int, dtype: torch.dtype, *, lead=(),
             device: Optional[torch.device] = None) -> dict:
    """One MoE block's parameters, or a stack of them when ``lead`` (e.g.
    ``(n_layers,)``) is given; the reference's distributions (its fan-in is
    a shape's first axis: the expert count for ``w_gate``/``w_up``)."""
    lead = tuple(lead)
    e, f = n_experts, moe_d_ff
    p = {
        "router": dense_init(gen, lead + (d, e), dtype, fan_in=d,
                             device=device),
        "experts": {
            "w_gate": dense_init(gen, lead + (e, d, f), dtype, fan_in=e,
                                 device=device),
            "w_up": dense_init(gen, lead + (e, d, f), dtype, fan_in=e,
                               device=device),
            "w_down": dense_init(gen, lead + (e, f, d), dtype, fan_in=f,
                                 scale=1.0 / math.sqrt(f), device=device),
        },
    }
    if shared_d_ff:
        p["shared"] = init_gated_mlp(gen, d, shared_d_ff, dtype, lead=lead,
                                     device=device)
    return p


def route(router_w: torch.Tensor, x: torch.Tensor, topk: int,
          norm_topk: bool, n_valid: Optional[int] = None) -> Tuple:
    """x [N, d] -> (weights [N, k] f32, ids [N, k] int32, probs [N, E] f32).

    Logits in f32 after the product in x's dtype; experts at or past
    ``n_valid`` (padding for an expert-parallel shard width) are masked to
    -1e30 and never chosen."""
    logits = (x @ router_w).float()
    e = logits.shape[-1]
    if n_valid is not None and n_valid < e:
        pad = torch.arange(e, device=x.device) >= n_valid
        logits = logits.masked_fill(pad[None], -1e30)
    probs = torch.softmax(logits, dim=-1)
    weights, ids = torch.topk(probs, topk, dim=-1)
    if norm_topk:
        weights = weights / weights.sum(dim=-1, keepdim=True)
    return weights, ids.to(torch.int32), probs


def load_balance_loss(probs: torch.Tensor, ids: torch.Tensor,
                      n_valid: int) -> torch.Tensor:
    """Switch-style auxiliary loss: E * sum_e f_e * P_e (padded experts are
    never routed, so they add 0)."""
    onehot = F.one_hot(ids.long(), probs.shape[-1]).float()      # [N, k, E]
    f = onehot.sum(dim=1).mean(dim=0)                        # routed share
    p = probs.mean(dim=0)
    return n_valid * (f * p).sum()


def moe_dense_oracle(params: dict, x: torch.Tensor, topk: int,
                     norm_topk: bool = False, act: str = "silu",
                     n_valid: Optional[int] = None) -> Tuple:
    """[B, S, d] -> ([B, S, d], aux): every expert over every token."""
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    n = xf.shape[0]
    weights, ids, probs = route(params["router"], xf, topk, norm_topk,
                                n_valid)
    ex = params["experts"]
    e = ex["w_gate"].shape[0]
    # the k chosen experts of a row are distinct: a plain scatter
    gates = torch.zeros((n, e), dtype=torch.float32, device=x.device)
    gates.scatter_(1, ids.long(), weights)
    # batched over the experts ([E, N, f]): an einsum "nd,edf->nef" would
    # first copy every expert's weights into a [d, E, f] layout
    g = torch.matmul(xf[None], ex["w_gate"])
    u = torch.matmul(xf[None], ex["w_up"])
    y = torch.bmm(act_fn(act)(g) * u, ex["w_down"])
    out = torch.einsum("end,ne->nd", y, gates.to(y.dtype))
    aux = load_balance_loss(probs, ids, e if n_valid is None else n_valid)
    return out.reshape(b, s, d), aux


def dispatch_indices(ids: torch.Tensor, weights: torch.Tensor, capacity: int,
                     n_experts: int) -> Tuple:
    """Slot assignment for capacity dispatch over all ``n_experts``.

    ids/weights [N, k] -> (slot_pair [E * C] int32, an index into the
    flattened N * k pairs; slot_w [E * C] f32; valid [E * C] bool). An
    expert takes its pairs in pair order up to ``capacity``; the rest go
    to the position ``E * C``, one past the end, which is cut off after
    the writes (the reference's ``mode="drop"``; no host sync on the
    card)."""
    dev = ids.device
    ids_f = ids.reshape(-1).long()
    nk = ids_f.shape[0]
    sel = ids_f[:, None] == torch.arange(n_experts, device=dev)[None]
    rank = torch.cumsum(sel, dim=0) * sel                 # 1-based rank
    keep = sel & (rank <= capacity)
    oob = n_experts * capacity
    flat_pos = torch.where(keep, ids_f[:, None] * capacity + rank - 1,
                           oob).amin(dim=1)               # one expert a pair
    # kept pairs take distinct slots; only the dropped share slot oob
    slot_pair = torch.zeros((oob + 1,), dtype=torch.int32, device=dev)
    slot_pair[flat_pos] = torch.arange(nk, dtype=torch.int32, device=dev)
    slot_w = torch.zeros((oob + 1,), dtype=torch.float32, device=dev)
    slot_w[flat_pos] = weights.reshape(-1).float()
    valid = torch.zeros((oob + 1,), dtype=torch.bool, device=dev)
    valid[flat_pos] = True
    return slot_pair[:oob], slot_w[:oob], valid[:oob]


def moe_capacity(params: dict, x: torch.Tensor, topk: int, *,
                 capacity_factor: float = 1.25, norm_topk: bool = False,
                 act: str = "silu", n_valid: Optional[int] = None) -> Tuple:
    """[B, S, d] -> ([B, S, d], aux) over all the experts; ``capacity =
    max(1, ceil(N k capacity_factor / E_valid))`` slots an expert."""
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    n = xf.shape[0]
    ex = params["experts"]
    e = ex["w_gate"].shape[0]
    weights, ids, probs = route(params["router"], xf, topk, norm_topk,
                                n_valid)
    e_valid = n_valid or e
    capacity = max(1, math.ceil(n * topk * capacity_factor / e_valid))
    slot_pair, slot_w, valid = dispatch_indices(ids, weights, capacity, e)
    tok = (slot_pair // topk).long()     # < N: an empty slot points at pair 0
    gt = (xf[tok] * valid[:, None].to(xf.dtype)).reshape(e, capacity, d)
    h = act_fn(act)(torch.bmm(gt, ex["w_gate"])) * torch.bmm(gt, ex["w_up"])
    y = torch.bmm(h, ex["w_down"]).reshape(e * capacity, d)
    y = y * slot_w[:, None].to(y.dtype)
    # the reference's scatter-add of the slots onto their tokens, without
    # atomics (so a run on the card gives the same bits each time): each
    # pair takes its slot's row, or a zero row where it was dropped, and a
    # token sums its k pairs
    nk, oob = n * topk, e * capacity
    pair_slot = torch.full((nk + 1,), oob, dtype=torch.long, device=x.device)
    pair_slot[torch.where(valid, slot_pair.long(), nk)] = torch.arange(
        oob, device=x.device)                   # empty slots land on nk
    y = torch.cat([y, y.new_zeros((1, d))])
    out = y[pair_slot[:nk]].reshape(n, topk, d).sum(dim=1)
    aux = load_balance_loss(probs, ids, e_valid)
    return out.reshape(b, s, d), aux
