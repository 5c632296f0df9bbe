"""Train-step builder: loss, gradients and AdamW, with remat and gradient
accumulation.

Counterpart of src/repro/training/train_step.py. ``make_train_step``
returns ``(params, opt_state, batch) -> (params, opt_state, metrics)``
with ``loss``, ``grad_norm`` and ``lr`` in ``metrics``. With ``accum > 1``
the batch's leading axis is split into ``accum`` microbatches whose
gradients are summed in ``accum_dtype``; loss and gradients are divided
by ``accum`` (the reference's ``lax.scan`` becomes a loop, one
microbatch's activations alive at a time).

Gradients come from ``torch.autograd.grad`` over the parameter leaves.
Each leaf takes part through a ``detach()``-ed alias that requires grad
for the step only: the caller's tensors never get ``requires_grad`` or a
``.grad``. On the card the kernel wrappers' forwards run the Hopper
kernels and their backwards recompute through the plain versions
(``kernels/*.py``: the reference has no backward kernel).

Under a model's ``dist`` (one rank of a mesh) the step is that rank's: the
FSDP gathers' backward has summed each sharded gradient over its FSDP
axes; the other gradients are summed over the data axes here, all are
divided by the data-parallel width (each rank's loss is the mean over its
own rows), the norm that clips them is taken over every rank's shards, and
the loss is averaged over the data axes (``tests/test_torch_spmd.py``
holds the result to the unsharded step's).
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..models.transformer import TORCH_DTYPES
from .optimizer import AdamWConfig, adamw_update, tree_leaves, tree_map


def make_loss_fn(model, *, q_chunk: int = 0, remat: str = "dots") -> Callable:
    def loss_fn(params, batch):
        return model.loss(params, batch, q_chunk=q_chunk, remat=remat)
    return loss_fn


def value_and_grad(loss_fn: Callable, params, batch) -> Tuple[torch.Tensor,
                                                             object]:
    """(loss, gradients) of ``loss_fn(params, batch)``, the gradients a
    tree like ``params`` (zeros for a leaf the loss does not reach, as
    ``jax.grad`` gives); the loss is detached."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    leaves = tree_leaves(live)
    with torch.enable_grad():
        loss = loss_fn(live, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g
              for p, g in zip(leaves, grads))
    return loss.detach(), tree_map(lambda _: next(it), live)


def make_train_step(model, opt_cfg: AdamWConfig, *, q_chunk: int = 0,
                    remat: str = "dots", accum: int = 1,
                    accum_dtype: str = "float32") -> Callable:
    loss_fn = make_loss_fn(model, q_chunk=q_chunk, remat=remat)

    def train_step(params, opt_state, batch) -> tuple:
        if accum <= 1:
            loss, grads = value_and_grad(loss_fn, params, batch)
        else:
            dt = TORCH_DTYPES[accum_dtype]
            loss = None
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=dt,
                                                   device=p.device), params)
            for i in range(accum):
                mb = {k: v.reshape(accum, v.shape[0] // accum,
                                   *v.shape[1:])[i]
                      for k, v in batch.items()}
                li, gi = value_and_grad(loss_fn, params, mb)
                li = li.float()
                loss = li if loss is None else loss + li
                grads = tree_map(lambda a, g: a.add_(g.to(a.dtype)), grads,
                                 gi)
                del gi
            loss = loss / accum
            grads = tree_map(lambda g: g / accum, grads)
        gn = None
        if getattr(model, "dist", None) and model.dist.get("spmd"):
            loss, grads, gn = _sync(model.dist, loss, grads)
        new_params, new_opt, metrics = adamw_update(params, grads, opt_state,
                                                    opt_cfg, grad_norm=gn)
        return new_params, new_opt, dict(metrics, loss=loss)

    return train_step


def _sync(dist: dict, loss, grads):
    """A rank's loss and gradients made the data-parallel step's, and the
    global gradient norm (module docstring)."""
    from ..parallel.sharding import _zip_map, entry_axes
    spmd, specs = dist["spmd"], dist["param_specs"]
    dp = entry_axes(dist.get("dp"))
    n_dp = spmd.size(dp) if dp else 1
    world = spmd.size(spmd.names)

    def leaf(g, spec):
        named = {a for e in spec for a in entry_axes(e)}
        rest = tuple(a for a in dp if a not in named)
        g = spmd._all_reduce(g, rest) if rest else g
        return g / n_dp if n_dp > 1 else g
    grads = _zip_map(leaf, grads, specs)
    sq = []

    def norm_leaf(g, spec):
        named = {a for e in spec for a in entry_axes(e)}
        copies = world // spmd.size(tuple(named)) if named else world
        sq.append(g.float().square().sum() / copies)
    _zip_map(norm_leaf, grads, specs)
    total = spmd._all_reduce(torch.stack(sq).sum(), spmd.names)
    if dp:
        loss = spmd._all_reduce(loss.float(), dp) / n_dp
    return loss, grads, torch.sqrt(total)
