"""Sharding rules, DTensor placements and the collectives of one rank.

Counterpart of src/repro/parallel/sharding.py. The strategy is the
reference's: FSDP over ("pod", "data"), tensor and expert parallelism over
"model".

  * 2D weights [d, f]      -> P(fsdp, "model") (transposed for *_down/out)
  * attention [d, H, dh]   -> heads over "model" when n_heads % tp == 0,
                              replicated otherwise (tiny archs)
  * KV caches              -> kv-heads over "model" when divisible; else the
                              *sequence* axis shards over "model"
  * MoE experts [E, d, f]  -> E over "model" (expert parallelism)

``ShardingRules`` keeps the reference's rule table and methods word for
word, with its ``no_fsdp``, ``dp_only`` and ``mlp_fsdp`` options, and
returns its specs as ``P`` (a tuple, as ``PartitionSpec`` is);
``params_tree``/``cache_tree`` give a ``Sharding`` (mesh and spec) a leaf.
``placements(spec, mesh)`` turns a spec into DTensor placements over a
``DeviceMesh``. A mesh is a ``torch.distributed.DeviceMesh`` with named
dimensions (``launch/mesh.py``), or any object with ``axis_names`` and a
``shape`` mapping, as the rules read only names and sizes.

Where the reference lets GSPMD place the collectives, the port's forward
runs as one rank on its shards (``shard_map`` over the whole model), and
``Spmd`` holds that rank's groups and the collectives it issues, with the
bytes each moves counted by kind (the reference's accounting: an
all-reduce moves twice its operand, an all-gather its result, a
reduce-scatter its operand). The collectives are the in-place ``c10d``
ones: they run over gloo (several ranks of one card, or CPU ranks) and
over the ``"fake"`` process group of the dry-run alike; the functional
collectives that DTensor's redistributions issue crash over gloo on CUDA
tensors (torch 2.11).

A block meets the model axis through a ``Region``. Work split over the
ranks (heads, ffn columns, experts) gets gradients that are partial sums
over the ranks; work every rank computes whole (replicated heads, an MLP
under ``mlp_fsdp``, an unsplit SSM, a router) gets whole gradients. With
the hidden states whole on the model axis, entering is Megatron's ``f``
for split work (``copy``: identity forward, all-reduce backward) and
leaving is its ``g`` (``reduce``: all-reduce forward, identity backward).
Under sequence parallelism (the reference's ``seq_shard``: the hidden
states between blocks are ``[B, S/tp, d]``, the rows of this rank's
``model`` coordinate) entering all-gathers the sequence, whose backward
reduce-scatters the split work's gradient and takes this rank's rows of
the whole work's; leaving reduce-scatters split work's sum (backward: an
all-gather) or takes this rank's rows of whole work (backward: an
all-gather, so that the whole work sees the gradient of every row).
``reduce_shared`` is an all-reduce both ways (a sum that feeds split work)
and ``gather`` an FSDP all-gather whose backward reduce-scatters (or,
over an axis whose ranks computed the same gradient, takes this rank's
slice).
"""
from __future__ import annotations

import copy
import math
import re
import warnings
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as tdist


class P(tuple):
    """A partition spec: one entry a tensor dimension, each ``None``, a
    mesh axis name, or a tuple of names (major first)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(e) for e in self) + ")"


def _join(*axes):
    """Combine axis names into one spec entry, skipping Nones."""
    flat = []
    for a in axes:
        if a is None:
            continue
        if isinstance(a, (tuple, list)):
            flat.extend(a)
        else:
            flat.append(a)
    if not flat:
        return None
    return tuple(flat) if len(flat) > 1 else flat[0]


def entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def mesh_axes(mesh) -> Tuple[Tuple[str, ...], Dict[str, int]]:
    """(axis names, {name: size}) of a DeviceMesh or a mesh-like object."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return tuple(names), {n: mesh.size(i) for i, n in enumerate(names)}
    names = tuple(mesh.axis_names)
    return names, {n: int(mesh.shape[n]) for n in names}


def _path_str(path: Sequence) -> str:
    return "/".join(str(k) for k in path)


def tree_with_path(fn, tree, path=()):
    """``fn(path_string, leaf)`` over a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(_path_str(path), tree)


class Sharding:
    """A leaf's mesh and spec (the reference's ``NamedSharding``)."""

    def __init__(self, mesh, spec: P):
        self.mesh = mesh
        self.spec = spec

    @property
    def placements(self):
        return placements(self.spec, self.mesh)

    def __repr__(self) -> str:
        return f"Sharding({self.spec!r})"


def placements(spec: P, mesh) -> list:
    """DTensor placements over ``mesh`` for ``spec``: ``Shard(i)`` on each
    mesh dimension that entry ``i`` names, ``Replicate()`` on the others. A
    tuple entry shards one tensor dimension over several mesh dimensions,
    in the mesh's order (major first, as JAX reads the tuple)."""
    from torch.distributed.tensor import Replicate, Shard
    names, _ = mesh_axes(mesh)
    out = [Replicate() for _ in names]
    for i, entry in enumerate(spec):
        axes = entry_axes(entry)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's "
                             f"order {names}")
        for j in order:
            out[j] = Shard(i)
    return out


def local_shape(shape: Sequence[int], spec: P, mesh) -> Tuple[int, ...]:
    _, sizes = mesh_axes(mesh)
    out = list(shape)
    for i, entry in enumerate(spec):
        n = math.prod(sizes[a] for a in entry_axes(entry))
        if out[i] % n:
            raise ValueError(f"dim {i} of {tuple(shape)} does not split "
                             f"{n} ways ({spec!r})")
        out[i] //= n
    return tuple(out)


def shard_index(entry, coord: Dict[str, int], sizes: Dict[str, int]) -> int:
    """This rank's chunk along a dimension split over ``entry``'s axes."""
    idx = 0
    for a in entry_axes(entry):
        idx = idx * sizes[a] + coord[a]
    return idx


def shard_local(t: torch.Tensor, spec: P, mesh,
                coord: Optional[Dict[str, int]] = None) -> torch.Tensor:
    """This rank's shard of the global tensor ``t`` under ``spec`` (what
    ``distribute_tensor(t, mesh, placements(spec, mesh)).to_local()``
    holds), as a tensor of its own storage."""
    names, sizes = mesh_axes(mesh)
    if coord is None:
        coord = {n: mesh.get_local_rank(n) for n in names}
    out = t
    for i, entry in enumerate(spec):
        if not entry_axes(entry):
            continue
        n = math.prod(sizes[a] for a in entry_axes(entry))
        step = t.shape[i] // n
        out = out.narrow(i, shard_index(entry, coord, sizes) * step, step)
    return out.clone() if out is not t else out


class ShardingRules:
    def __init__(self, cfg, mesh, *, fsdp_axes=None, tp_axis: str = "model",
                 no_fsdp: bool = False, dp_only: bool = False,
                 mlp_fsdp: bool = False):
        """no_fsdp: params replicate across data (weight-stationary serving —
        kills per-step FSDP all-gathers). dp_only: the ``model`` axis joins
        data parallelism (tiny archs where TP-16 is pure collective waste)."""
        self.cfg = cfg
        self.mesh = mesh
        axis_names, shape = mesh_axes(mesh)
        self._sizes = shape
        if dp_only:
            tp_axis = "__none__"
            fsdp_axes = tuple(a for a in ("pod", "data", "model")
                              if a in axis_names)
        if fsdp_axes is None:
            fsdp_axes = tuple(a for a in ("pod", "data") if a in axis_names)
        dp_axes = fsdp_axes
        if no_fsdp:
            fsdp_axes = ()
        self.fsdp = (None if not fsdp_axes else
                     (fsdp_axes if len(fsdp_axes) > 1 else fsdp_axes[0]))
        self.tp = tp_axis if tp_axis in axis_names else None
        tp_size = shape[tp_axis] if self.tp else 1
        self.tp_size = tp_size
        self.shard_heads = (bool(self.tp) and cfg.n_heads > 0
                            and cfg.n_heads % tp_size == 0)
        self.shard_kv = (bool(self.tp) and cfg.n_kv_heads > 0
                         and cfg.n_kv_heads % tp_size == 0)
        self.shard_ssm_heads = (bool(self.tp) and cfg.ssm_state > 0
                                and cfg.ssm_nheads % tp_size == 0)
        self.mlp_fsdp = mlp_fsdp
        self.dp = (dp_axes if len(dp_axes) > 1 else dp_axes[0])  # batch axes
        self._dp_size = math.prod(
            shape[a] for a in ((self.dp,) if isinstance(self.dp, str)
                               else self.dp))

    def for_batch(self, global_batch: int) -> "ShardingRules":
        """Batch-indivisible cells (long_500k B=1): batch replicates and the
        cache *sequence* axis takes over the data axes."""
        if global_batch % self._dp_size == 0:
            return self
        r = copy.copy(self)
        r.dp = None
        return r

    # -- parameters ---------------------------------------------------------
    def param_spec(self, path: str, ndim: int) -> P:
        spec = self._base_param_spec(path)
        if spec is None:
            return P()
        # stacked layers prepend L axes; pad spec with None on the left
        pad = ndim - len(spec)
        if pad > 0:
            spec = P(*([None] * pad), *spec)
        return spec

    def _base_param_spec(self, path: str) -> Optional[P]:
        f, t = self.fsdp, self.tp
        heads = t if self.shard_heads else None
        kv = t if self.shard_kv else None
        ssm_h = t if self.shard_ssm_heads else None

        table = [
            # vocab-parallel embedding / head: d replicated so the logits
            # contraction needs no resharding
            (r"embed$", P(t, None)),
            (r"lm_head$", P(None, t)),
            # attention
            (r"attn/wq$", P(f, heads, None)),
            (r"attn/wk$", P(f, kv, None)),
            (r"attn/wv$", P(f, kv, None)),
            (r"attn/wo$", P(heads, None, f)),
            (r"attn/bq$", P(heads, None)),
            (r"attn/bk$", P(kv, None)),
            (r"attn/bv$", P(kv, None)),
            (r"attn/bo$", P(None,)),
            # MLA
            (r"attn/q_down$", P(f, None)),
            (r"attn/q_up$", P(None, heads, None)),
            (r"attn/kv_down$", P(f, None)),
            (r"attn/k_up$", P(None, heads, None)),
            (r"attn/v_up$", P(None, heads, None)),
            (r"attn/(q_norm|kv_norm)$", P(None,)),
            # mlp (gated + plain); mlp_fsdp = weight-gather MLP: weights
            # shard over BOTH axes on d, activations stay full-d batch-
            # sharded -> no TP all-reduce after the MLP (weight all-gather
            # traffic replaces the larger activation all-reduce)
            (r"mlp/w_gate$", P(_join(f, t), None) if self.mlp_fsdp else P(f, t)),
            (r"mlp/w_up$", P(_join(f, t), None) if self.mlp_fsdp else P(f, t)),
            (r"mlp/w_down$", P(None, _join(f, t)) if self.mlp_fsdp else P(t, f)),
            (r"mlp/w_in$", P(f, t)),
            (r"mlp/w_out$", P(t, f)),
            (r"mlp/b_in$", P(t,)),
            (r"mlp/b_out$", P(None,)),
            # MoE
            (r"moe/router$", P(f, None)),
            (r"moe/experts/w_gate$", P(t, f, None)),
            (r"moe/experts/w_up$", P(t, f, None)),
            (r"moe/experts/w_down$", P(t, None, f)),
            (r"moe/shared/w_gate$", P(f, t)),
            (r"moe/shared/w_up$", P(f, t)),
            (r"moe/shared/w_down$", P(t, f)),
            # mamba2
            (r"mamba/w_z$", P(f, ssm_h)),
            (r"mamba/w_x$", P(f, ssm_h)),
            (r"mamba/w_bc$", P(f, None)),
            (r"mamba/w_dt$", P(f, ssm_h)),
            (r"mamba/(dt_bias|A_log|D)$", P(ssm_h,)),
            (r"mamba/conv_x$", P(None, ssm_h)),
            (r"mamba/conv_x_b$", P(ssm_h,)),
            (r"mamba/conv_bc$", P(None, None)),
            (r"mamba/conv_bc_b$", P(None,)),
            (r"mamba/norm$", P(ssm_h,)),
            (r"mamba/w_out$", P(ssm_h, f)),
            # zamba2 shared block extras
            (r"shared_attn/wo_down$", P(f, None)),
            # norms and leftovers
            (r"(ln\w*|norm|final_norm|enc_norm|dec_norm)(/[wb])?$", P(None,)),
        ]
        for pat, spec in table:
            if re.search(pat, path):
                return spec
        return P()

    def _sanitize(self, spec: P, shape) -> P:
        """Drop axes whose mesh-size doesn't divide the dim (e.g. vocab
        50280 % 16 != 0 -> embed vocab axis replicates instead)."""
        out = []
        for dim, entry in zip(shape, tuple(spec)
                              + (None,) * (len(shape) - len(spec))):
            if entry is None:
                out.append(None)
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            size = math.prod(self._sizes[a] for a in axes)
            out.append(entry if dim % size == 0 else None)
        return P(*out)

    def param_specs(self, params):
        """The sanitized spec of every parameter leaf (a tree like
        ``params``; leaves need ``shape`` and ``ndim``)."""
        return tree_with_path(
            lambda p, leaf: self._sanitize(self.param_spec(p, leaf.ndim),
                                           leaf.shape), params)

    def params_tree(self, params):
        return tree_with_path(
            lambda p, leaf: Sharding(self.mesh, self._sanitize(
                self.param_spec(p, leaf.ndim), leaf.shape)), params)

    # -- activations / inputs ----------------------------------------------
    def tokens_spec(self) -> P:
        return P(self.dp, None)

    def embeds_spec(self) -> P:
        return P(self.dp, None, None)

    def logits_spec(self) -> P:
        return P(self.dp, None, self.tp)

    # -- caches --------------------------------------------------------------
    def cache_spec(self, path: str, ndim: int) -> P:
        """Stacked caches: leading L axis, then [B, S, KV, dh] etc."""
        t, dp = self.tp, self.dp
        # when batch is replicated (B=1 cells) the sequence axis absorbs the
        # data axes so the cache still shards across the whole pod
        seq_extra = self.fsdp if dp is None else None
        if re.search(r"(^|/)(k|v)$", path):
            if self.shard_kv:
                spec = P(dp, seq_extra, t, None)
            else:
                spec = P(dp, _join(seq_extra, t), None, None)  # seq-sharded
            return self._pad(spec, ndim)
        if re.search(r"(k_scale|v_scale)$", path):
            spec = (P(dp, seq_extra, t) if self.shard_kv
                    else P(dp, _join(seq_extra, t), None))
            return self._pad(spec, ndim)
        if re.search(r"latent$", path):
            return self._pad(P(dp, _join(seq_extra, t), None), ndim)
        if re.search(r"k_rope$", path):
            return self._pad(P(dp, _join(seq_extra, t), None), ndim)
        if re.search(r"state$", path):                # ssm state [B,H,P,N]
            h = t if self.shard_ssm_heads else None
            return self._pad(P(dp, h, None, None), ndim)
        if re.search(r"conv_(x|bc)$", path):
            h = t if self.shard_ssm_heads else None
            if path.endswith("conv_bc"):
                h = None
            return self._pad(P(dp, None, h), ndim)
        return self._pad(P(), ndim)                    # length, slots_pos

    def _pad(self, spec: P, ndim: int) -> P:
        pad = ndim - len(spec)
        if pad > 0:
            return P(*([None] * pad), *spec)
        return spec

    def cache_specs(self, cache):
        return tree_with_path(
            lambda p, leaf: self._sanitize(self.cache_spec(p, leaf.ndim),
                                           leaf.shape), cache)

    def cache_tree(self, cache):
        return tree_with_path(
            lambda p, leaf: Sharding(self.mesh, self._sanitize(
                self.cache_spec(p, leaf.ndim), leaf.shape)), cache)

    def dist_ctx(self) -> dict:
        """Context dict the model threads through its forward passes: the
        reference's keys (layouts and flags), the KV cache's sequence
        entry, and ``spmd``, this rank's groups and collectives where the
        mesh is a DeviceMesh."""
        c = self.cfg
        k_seq = self.cache_spec("k", 4)[1]
        ctx = {
            "mesh": self.mesh, "dp": self.dp, "tp": self.tp,
            "tp_size": self.tp_size,
            "shard_heads": self.shard_heads, "shard_kv": self.shard_kv,
            "shard_ssm": self.shard_ssm_heads,
            "mlp_fsdp": self.mlp_fsdp,
            "vocab_tp": c.vocab_size % self.tp_size == 0,
            "dff_tp": (c.d_ff % self.tp_size == 0 if c.d_ff else False),
            # the port's additions: sequence parallelism, which the
            # reference's dry-run sets after this call (``seq_shard``)
            "seq_shard": False,
            "fsdp": self.fsdp,
            "shared_tp": (c.shared_d_ff % self.tp_size == 0
                          if c.shared_d_ff else False),
            "kv_seq": k_seq,
            "latent_seq": self.cache_spec("latent", 3)[1],
        }
        if hasattr(self.mesh, "mesh_dim_names"):
            ctx["spmd"] = Spmd(self.mesh)
        return ctx


class ActConstraint:
    """The activation boundaries where the reference constrains a layout
    (``with_sharding_constraint``). The port's forward runs as one rank on
    its local shards, whose layout the code holds by construction (the
    blocks' ``Region``s place the collectives, sequence parallelism's
    among them), so each boundary is the identity; the calls mark where
    the reference places them."""

    def __init__(self, dist: Optional[dict]):
        self.d = dist

    def _local(self, x):
        return x

    # hidden [B, S, d], heads / kv_heads [B, S, H, dh], ffn [B, S, d_ff],
    # logits [B, S, V], ssm_heads [B, L, H, P], ssm_inner [B, L, d_inner]
    hidden = heads = kv_heads = ffn = logits = ssm_heads = ssm_inner = _local


# ---------------------------------------------------------------------------
# One rank's collectives
# ---------------------------------------------------------------------------
_SIDE = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0}


class CollectiveCounts:
    """Calls and bytes moved per device, by kind (the reference's
    ``parse_collectives`` accounting)."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.bytes_by_op: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    def add(self, kind: str, nbytes: float) -> None:
        self.bytes_by_op[kind] = (self.bytes_by_op.get(kind, 0.0)
                                  + _SIDE[kind] * nbytes)
        self.counts[kind] = self.counts.get(kind, 0) + 1

    def as_dict(self) -> dict:
        return {"bytes_by_op": dict(self.bytes_by_op),
                "counts": dict(self.counts),
                "total_bytes": float(sum(self.bytes_by_op.values()))}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Spmd:
    """One rank of a named DeviceMesh: its coordinate, a process group a
    mesh dimension, and the collectives over groups of dimensions (a
    dimension of size 1 takes part in none)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.names, self.sizes = mesh_axes(mesh)
        self.coord = {n: mesh.get_local_rank(n) for n in self.names}
        self.groups = {n: mesh.get_group(n) for n in self.names}
        self.counts = CollectiveCounts()
        # the top-level parameter keys whose row leaves (``SEQ_ROW_LEAF``)
        # ran on this rank's sequence shard (``seq_dist``)
        self.seq_rows = set()
        # gloo sums bf16 through f32 here: its own bf16 sum rounds each
        # partial, and the bytes counted stay the operand's
        self.upcast = tdist.get_backend() == "gloo"

    def size(self, axes) -> int:
        return math.prod(self.sizes[a] for a in entry_axes(axes))

    def rank(self, axes) -> int:
        return shard_index(axes, self.coord, self.sizes)

    def _live(self, axes) -> Tuple[str, ...]:
        return tuple(a for a in entry_axes(axes) if self.sizes[a] > 1)

    # -- raw collectives (no autograd) ---------------------------------
    def _all_reduce(self, x: torch.Tensor, axes, op: str = "sum"):
        live = self._live(axes)
        if not live:
            return x
        up = self.upcast and x.dtype in (torch.bfloat16, torch.float16)
        y = x.float() if up else x.contiguous().clone()
        rop = {"sum": tdist.ReduceOp.SUM, "max": tdist.ReduceOp.MAX}[op]
        for a in live:
            self.counts.add("all-reduce", _nbytes(x))
            tdist.all_reduce(y, op=rop, group=self.groups[a])
        return y.to(x.dtype) if up else y

    def _all_gather(self, x: torch.Tensor, dim: int, axes):
        for a in reversed(self._live(axes)):        # minor axis first
            n = self.sizes[a]
            src = x.movedim(dim, 0).contiguous()
            out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                              dtype=x.dtype, device=x.device)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", FutureWarning)
                tdist.all_gather_into_tensor(out, src, group=self.groups[a])
            self.counts.add("all-gather", _nbytes(out))
            x = out.movedim(0, dim)
        return x

    def _reduce_scatter(self, x: torch.Tensor, dim: int, axes, whole=()):
        """Sum over ``axes`` and keep this rank's chunk along ``dim``; over
        an axis of ``whole`` (whose ranks hold the same tensor) only keep
        the chunk."""
        whole = entry_axes(whole)
        up = self.upcast and x.dtype in (torch.bfloat16, torch.float16)
        for a in self._live(axes):                  # major axis first
            n = self.sizes[a]
            if a in whole:
                x = self._rows(x, a, dim)
                continue
            src = x.movedim(dim, 0).contiguous()
            out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                              dtype=torch.float32 if up else x.dtype,
                              device=x.device)
            self.counts.add("reduce-scatter", _nbytes(src))
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", FutureWarning)
                tdist.reduce_scatter_tensor(out, src.float() if up else src,
                                            group=self.groups[a])
            x = (out.to(x.dtype) if up else out).movedim(0, dim)
        return x

    def _rows(self, x: torch.Tensor, axes, dim: int = 1) -> torch.Tensor:
        """This rank's chunk of ``x`` along ``dim`` split over ``axes``."""
        n = self.size(axes)
        step = x.shape[dim] // n
        return x.narrow(dim, self.rank(axes) * step, step)

    # -- autograd-aware ---------------------------------------------------
    def reduce(self, x: torch.Tensor, axes) -> torch.Tensor:
        """Sum over ``axes`` (Megatron's ``g``: backward is the identity)."""
        if not self._live(axes):
            return x
        if torch.is_grad_enabled() and x.requires_grad:
            return _Reduce.apply(x, self, axes)
        return self._all_reduce(x, axes)

    def reduce_shared(self, x: torch.Tensor, axes) -> torch.Tensor:
        """Sum over ``axes`` feeding work split over them: the backward
        sums the ranks' gradients too."""
        if not self._live(axes):
            return x
        if torch.is_grad_enabled() and x.requires_grad:
            return _ReduceShared.apply(x, self, axes)
        return self._all_reduce(x, axes)

    def copy(self, x: torch.Tensor, axes) -> torch.Tensor:
        """Identity whose backward sums over ``axes`` (Megatron's ``f``)."""
        if (not self._live(axes) or not torch.is_grad_enabled()
                or not x.requires_grad):
            return x
        return _Copy.apply(x, self, axes)

    def gather(self, x: torch.Tensor, dim: int, axes,
               whole=()) -> torch.Tensor:
        """All-gather along ``dim`` over ``axes`` (backward:
        reduce-scatter; over the axes of ``whole``, whose ranks compute the
        same gradient, this rank's slice)."""
        if not self._live(axes):
            return x
        if torch.is_grad_enabled() and x.requires_grad:
            return _Gather.apply(x, self, dim, axes, whole)
        return self._all_gather(x, dim, axes)

    def seq_enter(self, x: torch.Tensor, axes) -> Tuple[torch.Tensor,
                                                         torch.Tensor]:
        """Rows split over ``axes`` gathered whole along the sequence (dim
        1), twice: for work split over ``axes`` (backward: reduce-scatter)
        and for work every rank computes whole (backward: this rank's
        rows). One all-gather forward, at most one reduce-scatter
        backward."""
        if torch.is_grad_enabled() and x.requires_grad:
            return _SeqEnter.apply(x, self, axes)
        out = self._all_gather(x, 1, axes)
        return out, out

    def seq_leave(self, y: torch.Tensor, axes, summed: bool) -> torch.Tensor:
        """This rank's rows of ``y`` (dim 1): a reduce-scatter of split
        work's partial sums (``summed``), else a slice of whole work; the
        backward all-gathers the rows' gradient."""
        if torch.is_grad_enabled() and y.requires_grad:
            return _SeqLeave.apply(y, self, axes, summed)
        if summed:
            return self._reduce_scatter(y, 1, axes)
        return self._rows(y, axes).clone()

    def max(self, x: torch.Tensor, axes) -> torch.Tensor:
        return self._all_reduce(x.detach(), axes, "max")

    def gather_tree(self, tree, specs, fsdp, whole=()):
        """Each leaf gathered along the dimensions its spec shards over the
        FSDP axes (the weights of one layer, just before use), and over
        the axes of ``whole`` (the ``model`` axis of ``mlp_fsdp``'s
        weights, which every rank then uses whole: backward, a slice)."""
        fs = set(entry_axes(fsdp)) | set(entry_axes(whole))
        if not any(self.sizes[a] > 1 for a in fs):
            return tree

        def leaf(t, spec):
            for i, entry in enumerate(spec):
                axes = tuple(a for a in entry_axes(entry) if a in fs)
                if axes:
                    t = self.gather(t, i, axes, whole)
            return t
        return _zip_map(leaf, tree, specs)


def _zip_map(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip_map(fn, v, s) for v, s in zip(tree, specs))
    return fn(tree, specs)


def index_specs(specs):
    """The specs of one layer of a stacked tree (its first entry
    dropped)."""
    if isinstance(specs, dict):
        return {k: index_specs(v) for k, v in specs.items()}
    if isinstance(specs, list):
        return [index_specs(v) for v in specs]
    return P(*specs[1:])


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, spmd, axes):
        return spmd._all_reduce(x, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _ReduceShared(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, spmd, axes):
        ctx.spmd, ctx.axes = spmd, axes
        return spmd._all_reduce(x, axes)

    @staticmethod
    def backward(ctx, g):
        return ctx.spmd._all_reduce(g, ctx.axes), None, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, spmd, axes):
        ctx.spmd, ctx.axes = spmd, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.spmd._all_reduce(g, ctx.axes), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, spmd, dim, axes, whole):
        ctx.spmd, ctx.dim, ctx.axes, ctx.whole = spmd, dim, axes, whole
        return spmd._all_gather(x, dim, axes)

    @staticmethod
    def backward(ctx, g):
        return (ctx.spmd._reduce_scatter(g, ctx.dim, ctx.axes, ctx.whole),
                None, None, None, None)


class _SeqEnter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, spmd, axes):
        ctx.set_materialize_grads(False)
        ctx.spmd, ctx.axes = spmd, axes
        out = spmd._all_gather(x, 1, axes)
        return out, out.view_as(out)

    @staticmethod
    def backward(ctx, g_split, g_whole):
        out = None
        if g_split is not None:
            out = ctx.spmd._reduce_scatter(g_split, 1, ctx.axes)
        if g_whole is not None:
            mine = ctx.spmd._rows(g_whole, ctx.axes)
            out = mine if out is None else out + mine
        return out, None, None


class _SeqLeave(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, spmd, axes, summed):
        ctx.spmd, ctx.axes = spmd, axes
        if summed:
            return spmd._reduce_scatter(y, 1, axes)
        return spmd._rows(y, axes).clone()

    @staticmethod
    def backward(ctx, g):
        return ctx.spmd._all_gather(g, 1, ctx.axes), None, None, None


# ---------------------------------------------------------------------------
# Helpers the models call under ``dist``
# ---------------------------------------------------------------------------
def tp_if(dist: Optional[dict], flag: Optional[str] = None):
    """(spmd, model axis) where ``dist`` splits work over a model axis of
    more than one rank and, given ``flag`` (e.g. ``"dff_tp"``,
    ``"shard_heads"``), ``dist[flag]`` says that dimension splits; else
    None."""
    if (not dist or dist.get("spmd") is None or not dist.get("tp")
            or (flag is not None and not dist.get(flag))
            or dist["spmd"].size(dist["tp"]) <= 1):
        return None
    return dist["spmd"], dist["tp"]


class Region:
    """Where a block's hidden rows meet the work it spreads over the
    model axis (module docstring). ``split`` (a bool, or a key of
    ``dist`` such as ``"shard_heads"``) says the block's own work is
    split over the ranks; ``seq`` (default ``dist["seq"]``, set by
    ``seq_dist``) that the rows are this rank's sequence shard. Without a
    model axis of more than one rank every step is the identity."""

    def __init__(self, dist: Optional[dict], split=True, *, seq=None):
        live = tp_if(dist)
        self.spmd, self.tp = live if live is not None else (None, None)
        if isinstance(split, str):
            split = bool(dist and dist.get(split))
        self.split = live is not None and bool(split)
        if seq is None:
            seq = bool(dist and dist.get("seq"))
        self.seq = live is not None and bool(seq)

    def enter_both(self, x: torch.Tensor) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
        """(``x`` for work split over the ranks, ``x`` for work every rank
        computes whole), whole along the sequence."""
        if self.spmd is None:
            return x, x
        if self.seq:
            return self.spmd.seq_enter(x, self.tp)
        return (self.spmd.copy(x, self.tp) if self.split else x), x

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` for this region's own work (split or whole)."""
        xs, xw = self.enter_both(x)
        return xs if self.split else xw

    def leave(self, y: torch.Tensor, summed: Optional[bool] = None
              ) -> torch.Tensor:
        """The block's output on the hidden rows: summed over the ranks
        where it is split work's partial sum (``summed``, by default
        ``split``), else the whole work's own."""
        if self.spmd is None:
            return y
        summed = self.split if summed is None else summed
        if self.seq:
            return self.spmd.seq_leave(y, self.tp, summed)
        return self.spmd.reduce(y, self.tp) if summed else y

    def rows(self, t: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's rows of ``t`` (a tensor every rank holds whole that
        needs no gradient across the ranks, e.g. positions)."""
        if not self.seq:
            return t
        return self.spmd._rows(t, self.tp, dim)


def seq_dist(dist: Optional[dict], s: int, roots=()) -> Optional[dict]:
    """``dist`` for a stream of hidden states of ``s`` rows, with ``"seq"``
    set where sequence parallelism applies: ``seq_shard`` asked for, a
    model axis of more than one rank, and ``s`` divisible by its width
    (the reference's ``ActConstraint.hidden``; never at decode, S 1).
    ``roots`` (the stream's top-level parameter keys) are recorded on the
    ``Spmd`` where it applies, for the gradient sync of their row
    leaves."""
    if not dist:
        return dist
    live = tp_if(dist)
    on = bool(live is not None and dist.get("seq_shard")
              and s % live[0].size(live[1]) == 0)
    if on:
        live[0].seq_rows.update(roots)
    return dict(dist, seq=on)


# leaves that act on the hidden rows between the blocks (the norms, the
# output biases added after a block leaves the model axis, MLA's low-rank
# projections and their norms, which run on the rows before the latent's
# gather): under sequence parallelism each rank's gradient of one covers
# its own rows only
SEQ_ROW_LEAF = re.compile(
    r"(^|/)(ln\w*|final_norm|enc_norm|dec_norm)(/[wb])?$"
    r"|attn/(bo|q_down|kv_down|q_norm|kv_norm)$|mlp/b_out$")


def seq_row_leaf(path: str, roots) -> bool:
    """``path`` (a parameter leaf) is a row leaf of a stream that ran on
    sequence shards (``roots``: ``Spmd.seq_rows``)."""
    return path.split("/")[0] in roots and bool(SEQ_ROW_LEAF.search(path))


def vocab_parallel_nll(logits: torch.Tensor, targets: torch.Tensor,
                       dist: dict) -> torch.Tensor:
    """Mean next-token NLL in f32 of logits split over the vocabulary (this
    rank's slice [.., V / tp]); the plain NLL where they are whole."""
    split = tp_if(dist, "vocab_tp")
    lf = logits.float()
    if split is None:
        lse = torch.logsumexp(lf, dim=-1)
        gold = lf.gather(-1, targets[..., None].long())[..., 0]
        return (lse - gold).mean()
    spmd, tp = split
    v_loc = lf.shape[-1]
    m = spmd.max(lf.amax(dim=-1), tp)
    se = spmd.reduce(torch.exp(lf - m[..., None]).sum(dim=-1), tp)
    lse = m + torch.log(se)
    ids = targets.long() - spmd.rank(tp) * v_loc
    mine = (ids >= 0) & (ids < v_loc)
    gold = lf.gather(-1, ids.clamp(0, v_loc - 1)[..., None])[..., 0]
    gold = spmd.reduce(torch.where(mine, gold, torch.zeros_like(gold)), tp)
    return (lse - gold).mean()
