"""Mamba2 (state-space duality) block: chunked SSD prefill, O(1) decode.

Counterpart of src/repro/models/mamba2.py, with its layouts: split
projections ``w_z/w_x [d, d_inner]``, ``w_bc [d, 2 G N]``, ``w_dt [d, H]``,
depthwise conv kernels ``[W, C]``, and a cache ``{"conv_x", "conv_bc",
"state", "length"}`` whose conv histories are in the model dtype and whose
state is f32. Prefill goes through the SSD kernel wrapper
(``kernels/ssd_scan.py``: the Hopper kernel on the card, ``ssd_reference``
below on the CPU); decode is the token recurrence ``ssd_decode_step`` in
plain PyTorch, as in the reference, where it is no Pallas kernel either.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels._lib import at_least_f32
from ..kernels.ssd_scan import ssd
from ..parallel.sharding import Region
from .layers import dense_init, rms_norm


def init_mamba2(gen: torch.Generator, cfg, dtype: torch.dtype, *, lead=(),
                device: Optional[torch.device] = None) -> dict:
    """One block's parameters, or a stack of them when ``lead`` (e.g.
    ``(n_layers,)``) is given; the reference's distributions."""
    lead = tuple(lead)
    d, di, h = cfg.d_model, cfg.d_inner, cfg.ssm_nheads
    gn2 = 2 * cfg.ssm_ngroups * cfg.ssm_state
    w = cfg.ssm_conv_width

    def full(shape, value):
        return torch.full(lead + shape, value, dtype=dtype, device=device)

    a_log = torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32,
                                     device=device)).to(dtype)
    return {
        "w_z": dense_init(gen, lead + (d, di), dtype, fan_in=d, device=device),
        "w_x": dense_init(gen, lead + (d, di), dtype, fan_in=d, device=device),
        "w_bc": dense_init(gen, lead + (d, gn2), dtype, fan_in=d,
                           device=device),
        "w_dt": dense_init(gen, lead + (d, h), dtype, fan_in=d, device=device),
        "dt_bias": full((h,), 0.0),
        "A_log": a_log.expand(*lead, h).clone(),
        "D": full((h,), 1.0),
        "conv_x": dense_init(gen, lead + (w, di), dtype, fan_in=w, scale=0.5,
                             device=device),
        "conv_x_b": full((di,), 0.0),
        "conv_bc": dense_init(gen, lead + (w, gn2), dtype, fan_in=w,
                              scale=0.5, device=device),
        "conv_bc_b": full((gn2,), 0.0),
        "norm": full((di,), 1.0),
        "w_out": dense_init(gen, lead + (di, d), dtype, fan_in=di,
                            scale=1.0 / math.sqrt(di), device=device),
    }


def make_ssm_cache(batch: int, cfg, dtype: torch.dtype,
                   device: Optional[torch.device] = None) -> dict:
    w = cfg.ssm_conv_width
    gn2 = 2 * cfg.ssm_ngroups * cfg.ssm_state
    return {
        "conv_x": torch.zeros((batch, w - 1, cfg.d_inner), dtype=dtype,
                              device=device),
        "conv_bc": torch.zeros((batch, w - 1, gn2), dtype=dtype,
                               device=device),
        "state": torch.zeros((batch, cfg.ssm_nheads, cfg.ssm_headdim,
                              cfg.ssm_state), dtype=torch.float32,
                             device=device),
        "length": torch.zeros((), dtype=torch.int32, device=device),
    }


def causal_conv(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                history: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv as W shifted adds. x: [B,L,C], kernel: [W,C].

    Returns (y [B,L,C], new_history [B,W-1,C])."""
    w = kernel.shape[0]
    if history is None:
        history = torch.zeros((x.shape[0], w - 1, x.shape[2]), dtype=x.dtype,
                              device=x.device)
    xp = torch.cat([history.to(x.dtype), x], dim=1)
    ln = x.shape[1]
    y = sum(xp[:, i:i + ln] * kernel[i][None, None] for i in range(w))
    y = F.silu(y + bias)
    return y, xp[:, -(w - 1):]


def _segsum(da: torch.Tensor) -> torch.Tensor:
    """da: [..., Q] -> [..., Q, Q], out[i, j] = sum_{j<k<=i} da[k], -inf for
    j > i."""
    q = da.shape[-1]
    cs = torch.cumsum(da, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=da.device))
    return diff.masked_fill(~mask, -math.inf)


def ssd_reference(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                  b: torch.Tensor, c: torch.Tensor, chunk: int,
                  init_state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD. x:[B,L,H,P] dt:[B,L,H] (post-softplus) b/c:[B,L,G,N].

    Returns (y [B,L,H,P], final_state [B,H,P,N] f32). The plain version of
    the SSD kernel. It computes in f32 (in f64 for f64 inputs)."""
    f32 = at_least_f32
    bs, ln, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if ln % chunk:
        raise ValueError(f"L={ln} not divisible by chunk={chunk}")
    nc = ln // chunk
    rep = h // g
    a = -torch.exp(f32(a_log))                             # [H], negative
    xc = x.reshape(bs, nc, chunk, h, p)
    dtc = f32(dt.reshape(bs, nc, chunk, h))
    bc = b.reshape(bs, nc, chunk, g, n).repeat_interleave(rep, dim=3)
    cc = c.reshape(bs, nc, chunk, g, n).repeat_interleave(rep, dim=3)
    da_hq = (dtc * a).movedim(-1, 2)                        # [B,nc,H,Q]
    decay = torch.exp(_segsum(da_hq))                       # [B,nc,H,Q,Q]
    # intra-chunk (quadratic within the chunk); C.B in the inputs' dtype
    cb = f32(torch.einsum("bcqhn,bckhn->bchqk", cc, bc))
    y_intra = torch.einsum("bchqk,bckh,bckhp->bcqhp", cb * decay, dtc,
                           f32(xc))
    # per-chunk final states
    cum = torch.cumsum(da_hq, dim=-1)                       # [B,nc,H,Q]
    decay_to_end = torch.exp(cum[..., -1:] - cum)
    states = torch.einsum("bckhn,bchk,bckh,bckhp->bchpn", f32(bc),
                          decay_to_end, dtc, f32(xc))
    # inter-chunk recurrence
    chunk_decay = torch.exp(cum[..., -1])                   # [B,nc,H]
    prev = f32(torch.zeros((bs, h, p, n), device=x.device, dtype=x.dtype)
               if init_state is None else init_state)
    prev_states = []
    for ci in range(nc):
        prev_states.append(prev)
        prev = prev * chunk_decay[:, ci, :, None, None] + states[:, ci]
    prev_states = torch.stack(prev_states, dim=1)           # [B,nc,H,P,N]
    y_inter = torch.einsum("bcqhn,bchq,bchpn->bcqhp", f32(cc),
                           torch.exp(cum), prev_states)
    y = (y_intra + y_inter).reshape(bs, ln, h, p)
    return y.to(x.dtype), prev


def ssd_decode_step(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                    a_log: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                    in_place: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token recurrence. x:[B,H,P] dt:[B,H] b/c:[B,G,N].

    state' = state * exp(dt*A) + dt * (B outer x);  y = C . state'

    With ``in_place`` state' is written into ``state`` (``mul_`` by the
    decay, then ``add_`` of the same product, in the same order: the f32
    state is bit-identical to the functional step's) and returned."""
    rep = x.shape[1] // b.shape[1]
    a = -torch.exp(a_log.float())
    bh = b.repeat_interleave(rep, dim=1).float()            # [B,H,N]
    ch = c.repeat_interleave(rep, dim=1).float()
    dtf = dt.float()
    decay = torch.exp(dtf * a[None])                        # [B,H]
    xt = x.float()
    if in_place:
        upd = dtf[:, :, None, None] * xt[:, :, :, None] * bh[:, :, None, :]
        new_state = state.mul_(decay[:, :, None, None]).add_(upd)
    else:
        new_state = (state * decay[:, :, None, None]
                     + dtf[:, :, None, None] * xt[:, :, :, None]
                     * bh[:, :, None, :])
    y = torch.einsum("bhpn,bhn->bhp", new_state, ch)
    return y.to(x.dtype), new_state


def mamba2_block(params: dict, x: torch.Tensor, *, cfg,
                 cache: Optional[dict] = None, cons=None,
                 dist: Optional[dict] = None, in_place: bool = False
                 ) -> Tuple[torch.Tensor, Optional[dict]]:
    """[B,L,d] -> ([B,L,d], new_cache). Decode (a cache and L == 1) runs
    the recurrent step; otherwise the chunked SSD. Under ``dist`` with the
    SSM heads split over the model axis the block runs on this rank's
    heads (``w_z``/``w_x``/``w_dt``, their conv channels, ``A_log``,
    ``D``, the norm's slice and ``w_out``'s rows): B and C are whole on
    every rank, the gated norm's mean square is summed over the ranks and
    the output too. Under sequence parallelism ``x`` is this rank's rows:
    the conv and the scan run on the sequence gathered whole, and the
    block returns this rank's rows (``parallel.sharding.Region``).
    ``in_place`` (decode): the new state, conv histories and ``length``
    are written into ``cache``'s own tensors, and ``cache`` returned."""
    reg = Region(dist, "shard_ssm")
    xs, x = reg.enter_both(x)
    xs = xs if reg.split else x
    bsz, ln, _ = x.shape
    p, g, n = cfg.ssm_headdim, cfg.ssm_ngroups, cfg.ssm_state
    h = params["A_log"].shape[-1]           # this rank's heads
    z = xs @ params["w_z"]
    xin = xs @ params["w_x"]
    bc = x @ params["w_bc"]
    dt = F.softplus((xs @ params["w_dt"]).float()
                    + params["dt_bias"].float())
    if cons is not None:
        z, xin = cons.ssm_inner(z), cons.ssm_inner(xin)

    hist_x = cache["conv_x"] if cache is not None else None
    hist_bc = cache["conv_bc"] if cache is not None else None
    xin, new_hist_x = causal_conv(xin, params["conv_x"], params["conv_x_b"],
                                  hist_x)
    bc, new_hist_bc = causal_conv(bc, params["conv_bc"], params["conv_bc_b"],
                                  hist_bc)
    if reg.split:                       # whole B and C, read by this rank's
        bc = reg.spmd.copy(bc, reg.tp)  # heads: their gradients summed

    xh = xin.reshape(bsz, ln, h, p)
    bmat = bc[..., :g * n].reshape(bsz, ln, g, n)
    cmat = bc[..., g * n:].reshape(bsz, ln, g, n)

    if cache is not None and ln == 1:
        y1, new_state = ssd_decode_step(cache["state"], xh[:, 0], dt[:, 0],
                                        params["A_log"], bmat[:, 0],
                                        cmat[:, 0], in_place)
        y = y1[:, None]
    elif in_place:
        raise ValueError("in_place writes a decode step's state (one token "
                         "with a cache)")
    else:
        init_state = cache["state"] if cache is not None else None
        # pad to a chunk multiple with dt = 0 tokens: zero dt means no state
        # update and unit decay, so the recurrence is unchanged
        pad = (-ln) % cfg.ssm_chunk
        xp, dtp, bp, cp = xh, dt, bmat, cmat
        if pad:
            xp = F.pad(xh, (0, 0, 0, 0, 0, pad))
            dtp = F.pad(dt, (0, 0, 0, pad))
            bp = F.pad(bmat, (0, 0, 0, 0, 0, pad))
            cp = F.pad(cmat, (0, 0, 0, 0, 0, pad))
        y, new_state = ssd(xp, dtp, params["A_log"], bp, cp, cfg.ssm_chunk,
                           init_state)
        if pad:
            y = y[:, :ln]

    y = y + params["D"].to(y.dtype)[None, None, :, None] * xh
    y = y.reshape(bsz, ln, h * p)
    y = y * F.silu(z.float()).to(y.dtype)
    if not reg.split:
        y = rms_norm(y, params["norm"], eps=cfg.norm_eps)
    else:
        # the norm spans every rank's heads: sum the squares over them
        ms = reg.spmd.reduce_shared(
            y.float().square().sum(-1, keepdim=True), reg.tp) / cfg.d_inner
        y = (y.float() * torch.rsqrt(ms + cfg.norm_eps)
             * params["norm"].float()).to(y.dtype)
    out = reg.leave(y @ params["w_out"])

    new_cache = None
    if in_place:
        cache["conv_x"].copy_(new_hist_x)
        cache["conv_bc"].copy_(new_hist_bc)
        cache["length"].add_(ln)
        new_cache = cache
    elif cache is not None:
        new_cache = {"conv_x": new_hist_x, "conv_bc": new_hist_bc,
                     "state": new_state, "length": cache["length"] + ln}
    return out, new_cache
