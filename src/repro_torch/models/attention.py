"""GQA attention of the LM paths: projections, rope, KV cache, and the
prefill and decode attention kernels.

Counterpart of src/repro/models/attention.py. Parameters keep the
reference layouts: ``wq [d, H, Dh]``, ``wk/wv [d, KV, Dh]``, ``wo [H, Dh,
d_out]`` (``d_out`` is ``d`` but for zamba2's shared block, which attends
over ``2 d`` and projects back to ``d``), optional biases ``bq/bk/bv [.,
Dh]`` and ``bo [d_out]`` (whisper). KV caches are dicts ``{"k", "v",
"slots_pos", "length"}`` with ``k/v [B, T, KV, Dh]``, ``slots_pos [T]``
(absolute position per slot, -1 = empty) and a 0-d ``length``; an int8
cache adds ``k_scale/v_scale [B, T, KV]`` f32, one absmax scale per token
and head.

Prefill (more than one query token, or no cache) attends on the fresh k/v
through the flash-attention kernel; decode (one token) reads the whole
cache through the decode-attention kernel, which takes the cache's own
layout through strides. Cross-attention (``x_kv``, whisper's decoder)
projects k/v from the encoder states and attends through the flash kernel
with keys of their own length, not causal, with no rope and no cache; the
reference computes it in plain ``jnp`` outside any kernel. An int8 cache
is dequantized to the compute dtype before the decode kernel, as the
reference dequantizes outside its kernels.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels import decode_attention as _dec
from ..kernels import flash_attention as _fa
from ..parallel.sharding import Region
from .layers import dense_init, rope_apply, rope_tables

SEQ_KEYS = ("k", "v", "k_scale", "v_scale", "latent", "k_rope")

def init_attention(gen: torch.Generator, d: int, n_heads: int, n_kv: int,
                   head_dim: int, dtype: torch.dtype, *, lead=(),
                   qkv_bias: bool = False, out_bias: bool = False,
                   d_out: Optional[int] = None,
                   device: Optional[torch.device] = None) -> dict:
    """Parameters for one attention block, or a stack of them when ``lead``
    (e.g. ``(n_layers,)``) is given; ``wo`` maps back to ``d_out``
    (default ``d``)."""
    lead = tuple(lead)
    d_out = d if d_out is None else d_out
    p = {
        "wq": dense_init(gen, lead + (d, n_heads, head_dim), dtype,
                         fan_in=d, device=device),
        "wk": dense_init(gen, lead + (d, n_kv, head_dim), dtype, fan_in=d,
                         device=device),
        "wv": dense_init(gen, lead + (d, n_kv, head_dim), dtype, fan_in=d,
                         device=device),
        "wo": dense_init(gen, lead + (n_heads, head_dim, d_out), dtype,
                         fan_in=n_heads, scale=(n_heads * head_dim) ** -0.5,
                         device=device),
    }
    if qkv_bias:
        for name, heads in (("bq", n_heads), ("bk", n_kv), ("bv", n_kv)):
            p[name] = torch.zeros(lead + (heads, head_dim), dtype=dtype,
                                  device=device)
    if out_bias:
        p["bo"] = torch.zeros(lead + (d_out,), dtype=dtype, device=device)
    return p


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------
def make_kv_cache(batch: int, max_len: int, n_kv: int, head_dim: int,
                  dtype: torch.dtype = torch.bfloat16,
                  device: Optional[torch.device] = None) -> dict:
    cache = {
        "length": torch.zeros((), dtype=torch.int32, device=device),
        "slots_pos": torch.full((max_len,), -1, dtype=torch.int32,
                                device=device),
        "k": torch.zeros((batch, max_len, n_kv, head_dim), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, max_len, n_kv, head_dim), dtype=dtype,
                         device=device),
    }
    if dtype == torch.int8:
        for name in ("k_scale", "v_scale"):
            cache[name] = torch.zeros((batch, max_len, n_kv),
                                      dtype=torch.float32, device=device)
    return cache


def _quant(x: torch.Tensor) -> tuple:
    """Per-token, per-head absmax int8 codes: scale = max|x| / 127 (at
    least 1e-8), codes = round-half-to-even(x / scale); no clamp, as in the
    reference (|x| / scale <= 127 by construction)."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1) / 127.0, min=1e-8)
    return torch.round(xf / scale[..., None]).to(torch.int8), scale


def _dequant(q: torch.Tensor, scale: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(dtype)


def write_slots(buf: torch.Tensor, val: torch.Tensor, slot: torch.Tensor,
                dim: int, in_place: bool = False) -> torch.Tensor:
    """``val`` into a copy of ``buf`` (into ``buf`` itself with
    ``in_place``) at ``slot`` along ``dim``; the slot is clamped to keep
    the block inside the buffer, as ``lax.dynamic_update_slice`` clamps
    it."""
    n, size = val.shape[dim], buf.shape[dim]
    idx = torch.clamp(slot, 0, size - n).long() + torch.arange(
        n, device=buf.device)
    if in_place:
        return buf.index_copy_(dim, idx, val.to(buf.dtype))
    return buf.index_copy(dim, idx, val.to(buf.dtype))


def update_kv_cache(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor,
                    start: torch.Tensor, in_place: bool = False) -> dict:
    """Write k/v [B, S_new, KV, D] at absolute position ``start`` (a 0-d
    tensor, so the host never waits for the device to learn it).

    Functional by default, as in the reference: returns a new cache and
    leaves ``cache`` untouched. The staged payloads share one prefilled
    donor cache across every job and lane, so an in-place write would
    corrupt it for all of them; ``write_slots`` writes into copies. With
    ``in_place`` the slots, ``slots_pos`` and ``length`` are written into
    ``cache``'s own tensors (a stage program's static copy, never the
    donor) and the same dict is returned, as XLA writes a scan's stacked
    output in place; ``length`` is written last, since ``start`` may be
    it."""
    out = cache if in_place else dict(cache)
    s_new = k_new.shape[1]
    s_max = cache["k"].shape[1]
    dev = cache["k"].device
    start = torch.as_tensor(start, dtype=torch.int32, device=dev)
    length_new = start + s_new
    if s_new > s_max:
        # ring cache smaller than the prefill: keep only the window tail
        k_new = k_new[:, -s_max:]
        v_new = v_new[:, -s_max:]
        start = start + (s_new - s_max)
        s_new = s_max
        slot = torch.zeros((), dtype=torch.int32, device=dev)
    else:
        slot = torch.remainder(start, s_max)
    if cache["k"].dtype == torch.int8:
        (k_new, ks), (v_new, vs) = _quant(k_new), _quant(v_new)
        out["k_scale"] = write_slots(cache["k_scale"], ks, slot, 1, in_place)
        out["v_scale"] = write_slots(cache["v_scale"], vs, slot, 1, in_place)
    out["k"] = write_slots(cache["k"], k_new, slot, 1, in_place)
    out["v"] = write_slots(cache["v"], v_new, slot, 1, in_place)
    out["slots_pos"] = write_slots(
        cache["slots_pos"],
        start + torch.arange(s_new, dtype=torch.int32, device=dev), slot, 0,
        in_place)
    if in_place:
        out["length"].copy_(length_new)
    else:
        out["length"] = length_new
    return out


def read_kv_cache(cache: dict, compute_dtype: torch.dtype) -> tuple:
    """Full-cache k/v in compute dtype + kv positions (-1 where empty)."""
    if cache["k"].dtype == torch.int8:
        return (_dequant(cache["k"], cache["k_scale"], compute_dtype),
                _dequant(cache["v"], cache["v_scale"], compute_dtype),
                cache["slots_pos"])
    return (cache["k"].to(compute_dtype), cache["v"].to(compute_dtype),
            cache["slots_pos"])


def seq_split(dist: Optional[dict], key: str) -> tuple:
    """(spmd, axes) where ``dist`` splits a cache's sequence axis over mesh
    axes of more than one rank (``dist[key]``: the cache spec's sequence
    entry), else (None, ())."""
    if not dist or dist.get("spmd") is None:
        return None, ()
    spmd = dist["spmd"]
    axes = spmd._live(dist.get(key))
    return (spmd, axes) if axes else (None, ())


def gather_seq(cache: dict, spmd, axes) -> dict:
    """A cache whose sequence axis (dim 1) is split over ``axes``, whole."""
    return {k: (spmd._all_gather(v, 1, axes) if k in SEQ_KEYS else v)
            for k, v in cache.items()}


def slice_seq(cache: dict, spmd, axes) -> dict:
    """This rank's part of a whole cache's sequence axis."""
    n, r = spmd.size(axes), spmd.rank(axes)

    def cut(v):
        step = v.shape[1] // n
        return v.narrow(1, r * step, step).clone()
    return {k: (cut(v) if k in SEQ_KEYS else v) for k, v in cache.items()}


def kv_head_range(dist: dict, h_loc: int, kvh: int) -> tuple:
    """The kv heads [lo, hi) that this rank's ``h_loc`` query heads read,
    when the query heads are split over the model axis and the kv heads
    are not (GQA: global head j reads kv head ``j // (H / KV)``)."""
    spmd, tp = dist["spmd"], dist["tp"]
    group = h_loc * spmd.size(tp) // kvh
    first = spmd.rank(tp) * h_loc
    return first // group, (first + h_loc - 1) // group + 1


# ---------------------------------------------------------------------------
# Full attention block (projections + rope + core + output)
# ---------------------------------------------------------------------------
def attention_block(params: dict, x: torch.Tensor, *, positions: torch.Tensor,
                    rope_theta: float = 10000.0, causal: bool = True,
                    window: int = 0, attn_softcap: float = 0.0,
                    scale: Optional[float] = None,
                    cache: Optional[dict] = None,
                    x_kv: Optional[torch.Tensor] = None,
                    q_chunk: int = 0, cons=None,
                    dist: Optional[dict] = None,
                    rope: Optional[tuple] = None,
                    in_place: bool = False) -> tuple:
    """x [B, S, d] -> (out [B, S, d], new_cache | None). ``q_chunk``
    blocks the queries of the flash call's plain version (the reference's
    ``mha``); the kernel ignores it. ``rope``: (cos, sin) from
    ``layers.rope_tables`` at this block's head width and ``positions``,
    shared by the layers of a stack (built here when None).
    ``in_place``: the cache update writes ``cache`` itself
    (``update_kv_cache``).

    Under ``dist`` the block runs on this rank's shards: its query heads
    (and kv heads where those split too) of ``wq``/``wk``/``wv``/``wo``,
    the output summed over the model axis. Where the kv heads do not split,
    every rank computes them whole and reads the subset of its query
    heads (their gradient summed over the ranks); a cache whose sequence
    axis is split is gathered whole, written, and cut back to this rank's
    part. Under sequence parallelism (``dist["seq"]``) ``x`` is this
    rank's rows: the block gathers the sequence first and returns this
    rank's rows (``parallel.sharding.Region``); ``x_kv`` is whole.

    - prefill: cache=None, or a fresh cache to fill;
    - decode: the cache holds the history, x is the new token (the decode
      kernel is causal by construction);
    - cross-attention: ``x_kv`` [B, S_kv, d] (encoder states), cache=None;
      not causal whatever ``causal`` says, as in the reference."""
    reg = Region(dist, "shard_heads")
    split_kv = reg.split and dist.get("shard_kv")
    xs, xw = reg.enter_both(x)
    x = xs if reg.split else xw
    if x_kv is None:
        src = xs if split_kv else xw
    else:
        src = Region(dist, split_kv, seq=False).enter(x_kv)
    b, s, d = x.shape
    s_kv = src.shape[1]
    h, dh = params["wq"].shape[-2:]
    kvh = params["wk"].shape[-2]
    q = (x @ params["wq"].reshape(d, h * dh)).view(b, s, h, dh)
    k = (src @ params["wk"].reshape(d, kvh * dh)).view(b, s_kv, kvh, dh)
    v = (src @ params["wv"].reshape(d, kvh * dh)).view(b, s_kv, kvh, dh)
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    if reg.split and not split_kv:         # whole k/v, read in part
        k, v = reg.spmd.copy(k, reg.tp), reg.spmd.copy(v, reg.tp)
    if cons is not None:
        q, k, v = cons.heads(q), cons.kv_heads(k), cons.kv_heads(v)
    if x_kv is not None:
        if cache is not None:
            raise ValueError("cross-attention (x_kv) takes no cache")
        causal = False
    elif rope_theta > 0.0:
        if rope is None:
            rope = rope_tables(positions, dh, rope_theta, q.device)
        q, k = rope_apply(q, *rope), rope_apply(k, *rope)
    if scale is None:
        scale = dh ** -0.5

    new_cache = full = None
    if cache is not None:
        spmd, axes = seq_split(dist, "kv_seq")
        if spmd is None:
            new_cache = full = update_kv_cache(cache, k, v, cache["length"],
                                               in_place)
        elif in_place:
            raise ValueError("in_place takes a whole cache, not a "
                             "sequence-split one")
        else:
            full = update_kv_cache(gather_seq(cache, spmd, axes), k, v,
                                   cache["length"])
            new_cache = slice_seq(full, spmd, axes)
    # this rank's query heads read a subset of whole kv heads
    pick = ((lambda t: t) if not reg.split or split_kv else
            (lambda t, r=kv_head_range(dist, h, kvh): t[:, :, r[0]:r[1]]))
    if cache is None or s > 1:
        # prefill from scratch: attend on the fresh k/v
        out = _fa.flash_attention(
            q.transpose(1, 2), pick(k).transpose(1, 2),
            pick(v).transpose(1, 2),
            causal=causal, window=window, softcap=attn_softcap,
            scale=scale, q_chunk=q_chunk).transpose(1, 2)
    else:
        kc, vc, kv_pos = read_kv_cache(full, x.dtype)
        q_pos = (positions if positions.dim() == 1
                 else positions[:, -1]).reshape(-1).expand(b)
        out = _dec.decode_attention(
            q[:, 0], pick(kc).transpose(1, 2), pick(vc).transpose(1, 2),
            kv_pos, q_pos, window=window, softcap=attn_softcap,
            scale=scale)[:, None]
    y = reg.leave(out.reshape(b, s, h * dh) @ params["wo"].reshape(h * dh,
                                                                    -1))
    if "bo" in params:
        y = y + params["bo"]
    return y, new_cache
