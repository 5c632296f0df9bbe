"""Mixture-of-Experts: router and two expert-compute paths.

Counterpart of src/repro/models/moe.py:

* ``moe_dense_oracle``: every expert over every token, weighted by the
  sparse gate matrix. Exact (no capacity drops); the staged decode path
  and the reference's small configs use it.
* ``moe_capacity``: gather, batched expert products, combine, with a fixed
  per-expert capacity; pairs past an expert's capacity are dropped, as in
  the reference. It computes the expert slice ``[expert_offset,
  expert_offset + n_local)`` whose parameters it is given (all of them by
  default).
* ``moe_ep``: expert parallelism over the mesh's ``model`` axis, the twin
  of the reference's ``moe_ep_shardmap``: each rank routes its tokens,
  computes only its slice of the experts and the ranks sum their outputs
  (one all-reduce, the one a tensor-parallel MLP needs anyway).

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
                     expert_offset, n_local: int) -> Tuple:
    """Slot assignment for capacity dispatch over the local expert slice
    ``[expert_offset, expert_offset + n_local)``.

    ids/weights [N, k] -> (slot_pair [E_loc * C] int32, an index into the
    flattened N * k pairs; slot_w [E_loc * C] f32; valid [E_loc * C]
    bool). An expert takes its pairs in pair order up to ``capacity``; the
    rest, and the pairs routed outside the slice, go to the position
    ``E_loc * C``, one past the end, which is cut off after the writes (the
    reference's ``mode="drop"``; no host sync on the card).
    ``expert_offset`` may be an int or a 0-d tensor."""
    dev = ids.device
    ids_f = ids.reshape(-1).long()
    nk = ids_f.shape[0]
    local = ids_f - expert_offset
    sel = local[:, None] == torch.arange(n_local, device=dev)[None]
    rank = torch.cumsum(sel, dim=0) * sel                 # 1-based rank
    keep = sel & (rank <= capacity)
    oob = n_local * capacity
    flat_pos = torch.where(keep, local[:, None] * capacity + rank - 1,
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
                 act: str = "silu", n_valid: Optional[int] = None,
                 expert_offset=0, n_local: Optional[int] = None,
                 precomputed_route: Optional[Tuple] = None) -> Tuple:
    """[B, S, d] -> ([B, S, d], aux) over the local expert slice
    ``[expert_offset, expert_offset + n_local)`` whose parameters
    ``params["experts"]`` holds (all the experts by default); ``capacity =
    max(1, ceil(N k capacity_factor / E_valid))`` slots an expert.
    ``precomputed_route`` is a ``route`` result to use in place of
    routing again."""
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    n = xf.shape[0]
    ex = params["experts"]
    el = ex["w_gate"].shape[0]                 # local expert count
    n_local = n_local or el
    if el != n_local:
        raise ValueError(f"expert slice of {el} experts, n_local {n_local}")
    if precomputed_route is not None:
        weights, ids, probs = precomputed_route
    else:
        weights, ids, probs = route(params["router"], xf, topk, norm_topk,
                                    n_valid)
    e_valid = n_valid or probs.shape[-1]
    capacity = max(1, math.ceil(n * topk * capacity_factor / e_valid))
    slot_pair, slot_w, valid = dispatch_indices(ids, weights, capacity,
                                                expert_offset, n_local)
    out = _expert_compute(ex, xf, slot_pair, slot_w, valid, capacity, act,
                          topk)
    aux = load_balance_loss(probs, ids, e_valid)
    return out.reshape(b, s, d), aux


def _expert_compute(experts: dict, xf: torch.Tensor, slot_pair, slot_w,
                    valid, capacity: int, act: str,
                    topk: int) -> torch.Tensor:
    """Gather, batched expert products, weighted combine: [N, d] -> [N, d]
    over the experts whose parameters ``experts`` holds."""
    n, d = xf.shape
    el = experts["w_gate"].shape[0]
    tok = (slot_pair // topk).long()     # < N: an empty slot points at pair 0
    gt = (xf[tok] * valid[:, None].to(xf.dtype)).reshape(el, capacity, d)
    h = (act_fn(act)(torch.bmm(gt, experts["w_gate"]))
         * torch.bmm(gt, experts["w_up"]))
    y = torch.bmm(h, experts["w_down"]).reshape(el * capacity, d)
    y = y * slot_w[:, None].to(y.dtype)
    # the reference's scatter-add of the slots onto their tokens, without
    # atomics (so a run on the card gives the same bits each time): each
    # pair takes its slot's row, or a zero row where it was dropped or
    # routed to another rank's experts, and a token sums its k pairs
    nk, oob = n * topk, el * capacity
    pair_slot = torch.full((nk + 1,), oob, dtype=torch.long, device=xf.device)
    pair_slot[torch.where(valid, slot_pair.long(), nk)] = torch.arange(
        oob, device=xf.device)                  # empty slots land on nk
    y = torch.cat([y, y.new_zeros((1, d))])
    return y[pair_slot[:nk]].reshape(n, topk, d).sum(dim=1)


def moe_ep(params: dict, x: torch.Tensor, *, topk: int, dist: dict,
           capacity_factor: float = 1.25, norm_topk: bool = False,
           act: str = "silu", n_valid: Optional[int] = None) -> Tuple:
    """Expert parallelism over ``dist``'s model axis, the twin of the
    reference's ``moe_ep_shardmap``: [B, S, d] -> ([B, S, d], aux).

    ``x`` is this rank's tokens, whole over the model axis (the attention's
    all-reduce before it makes it so); ``params["experts"]`` holds this
    rank's ``E_loc`` experts and ``params["router"]`` all of them. Each
    rank routes its tokens, takes ``offset = rank * E_loc``, computes only
    its slice and the ranks sum their outputs over the model axis; a pair
    lands in exactly one rank's slice, so the sum adds zeros elsewhere.
    ``aux`` is averaged over the data axes."""
    spmd, tp = dist["spmd"], dist["tp"]
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    n = xf.shape[0]
    e_loc = params["experts"]["w_gate"].shape[0]
    e_valid = n_valid or e_loc * spmd.size(tp)
    weights, ids, probs = route(params["router"], xf, topk, norm_topk,
                                n_valid)
    capacity = max(1, math.ceil(n * topk * capacity_factor / e_valid))
    # every rank routes all its tokens; its experts read a part of them and
    # of their weights, whose gradients the ranks sum
    slot_pair, slot_w, valid = dispatch_indices(
        ids, spmd.copy(weights, tp), capacity, spmd.rank(tp) * e_loc, e_loc)
    out = _expert_compute(params["experts"], spmd.copy(xf, tp), slot_pair,
                          slot_w, valid, capacity, act, topk)
    out = spmd.reduce(out, tp)
    aux = load_balance_loss(probs, ids, e_valid)
    dp = dist.get("dp")
    if dp:
        aux = spmd.reduce(aux, dp) / spmd.size(dp)
    return out.reshape(b, s, d), aux
