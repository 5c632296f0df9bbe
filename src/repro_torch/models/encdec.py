"""Whisper-style encoder-decoder backbone (the audio frontend is a stub).

Counterpart of src/repro/models/encdec.py. The caller gives precomputed
frame embeddings [B, F, d]; the encoder adds sinusoidal positions and runs
bidirectional layers (the flash-attention kernel, not causal, at S = F).
The decoder runs causal self-attention with a KV cache, then
cross-attention to the encoder states (recomputed every step, as the
reference does: the flash kernel with keys of their own length F), then a
biased GELU MLP; logits are tied to the embedding. Whisper's LayerNorms
and biased MLPs are plain torch ops; positions are sinusoidal (no rope).
Layers are lists, not stacks, as in the reference. Under sequence
parallelism (``transformer``'s module docstring) the encoder and the
decoder each split their rows over the model axis where their own length
divides it; the encoder's states leave it gathered whole.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..parallel.sharding import Region, seq_dist
from .attention import attention_block, init_attention, make_kv_cache
from .layers import (embed_init, init_mlp, layer_norm, mlp,
                     sinusoidal_positions)
from .transformer import (TORCH_DTYPES, fsdp_gather, lookup, maybe_remat,
                          project_vocab)


def _init_ln(d: int, dt: torch.dtype, device) -> dict:
    return {"w": torch.ones(d, dtype=dt, device=device),
            "b": torch.zeros(d, dtype=dt, device=device)}


def _attn(gen, cfg, dt, device) -> dict:
    return init_attention(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                          cfg.resolved_head_dim, dt, qkv_bias=True,
                          out_bias=True, device=device)


def init_encdec(gen: torch.Generator, cfg,
                device: Optional[torch.device] = None) -> dict:
    dt = TORCH_DTYPES[cfg.dtype]
    d = cfg.d_model

    def enc_layer():
        return {"ln1": _init_ln(d, dt, device),
                "attn": _attn(gen, cfg, dt, device),
                "ln2": _init_ln(d, dt, device),
                "mlp": init_mlp(gen, d, cfg.d_ff, dt, device=device)}

    def dec_layer():
        return {"ln1": _init_ln(d, dt, device),
                "self_attn": _attn(gen, cfg, dt, device),
                "ln_x": _init_ln(d, dt, device),
                "cross_attn": _attn(gen, cfg, dt, device),
                "ln2": _init_ln(d, dt, device),
                "mlp": init_mlp(gen, d, cfg.d_ff, dt, device=device)}

    return {
        "embed": embed_init(gen, cfg.vocab_size, d, dt, device),
        "enc_layers": [enc_layer() for _ in range(cfg.n_encoder_layers)],
        "enc_norm": _init_ln(d, dt, device),
        "dec_layers": [dec_layer() for _ in range(cfg.n_layers)],
        "dec_norm": _init_ln(d, dt, device),
    }


def _layer_specs(dist: Optional[dict], key: str, i: int):
    specs = (dist or {}).get("param_specs")
    return None if specs is None else specs[key][i]


def encode(params: dict, frames: torch.Tensor, cfg, cons=None,
           dist: Optional[dict] = None) -> torch.Tensor:
    """frames: [B, F, d] stub embeddings -> encoder states [B, F, d].
    Under ``dist`` one rank's program (``transformer.forward``)."""
    dist = seq_dist(dist, frames.shape[1], ("enc_layers", "enc_norm"))
    pos = sinusoidal_positions(frames.shape[1], cfg.d_model)
    x = Region(dist).leave(frames + pos.to(frames.device, frames.dtype)[None],
                           summed=False)
    f_pos = torch.arange(frames.shape[1], dtype=torch.int32,
                         device=frames.device)
    for i, lp in enumerate(params["enc_layers"]):
        lp = fsdp_gather(lp, dist, _layer_specs(dist, "enc_layers", i))
        h = layer_norm(x, lp["ln1"]["w"], lp["ln1"]["b"])
        a, _ = attention_block(lp["attn"], h, positions=f_pos,
                               rope_theta=0.0, causal=False, cons=cons,
                               dist=dist)
        x = x + a
        h = layer_norm(x, lp["ln2"]["w"], lp["ln2"]["b"])
        x = x + mlp(lp["mlp"], h, cfg.mlp_act, Region(dist, "dff_tp"))
        if cons is not None:
            x = cons.hidden(x)
    x = layer_norm(x, params["enc_norm"]["w"], params["enc_norm"]["b"])
    return Region(dist, False).enter(x)


def init_dec_cache(cfg, batch: int, max_len: int,
                   device: Optional[torch.device] = None) -> dict:
    return {"self": [make_kv_cache(batch, max_len, cfg.n_kv_heads,
                                   cfg.resolved_head_dim,
                                   TORCH_DTYPES[cfg.kv_cache_dtype], device)
                     for _ in range(cfg.n_layers)]}


def decode(params: dict, tokens: torch.Tensor, enc_out: torch.Tensor, cfg,
           cache: Optional[dict] = None,
           positions: Optional[torch.Tensor] = None, q_chunk: int = 0,
           remat: str = "none", cons=None,
           dist: Optional[dict] = None
           ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Decoder forward. tokens [B, S]; enc_out [B, F, d] -> (logits [B, S,
    vocab], new_cache | None). ``q_chunk`` blocks the attention's plain
    queries; any ``remat`` but ``"none"`` recomputes each decoder layer
    whole in the backward, as the reference does."""
    dist = seq_dist(dist, tokens.shape[1], ("dec_layers", "dec_norm"))
    x = lookup(params["embed"], tokens, cfg.vocab_size, dist)
    if positions is None:
        ar = torch.arange(tokens.shape[1], dtype=torch.int32,
                          device=x.device)
        positions = ar if cache is None else cache["self"][0]["length"] + ar
    x = x + Region(dist).rows(_pos_embed(positions, cfg.d_model),
                              0).to(x.dtype)[None]
    if cons is not None:
        x = cons.hidden(x)
    new_cache = {"self": []} if cache is not None else None
    layer = maybe_remat(dec_layer, "none" if remat == "none" else "full")
    for i, lp in enumerate(params["dec_layers"]):
        x, nc = layer(lp, x, enc_out, cfg, positions,
                      None if cache is None else cache["self"][i], q_chunk,
                      cons, dist, _layer_specs(dist, "dec_layers", i))
        if cache is not None:
            new_cache["self"].append(nc)
    x = layer_norm(x, params["dec_norm"]["w"], params["dec_norm"]["b"])
    logits = project_vocab(x, params["embed"].T, cfg.vocab_size, dist)
    if cons is not None:
        logits = cons.logits(logits)
    return logits, new_cache


def dec_layer(lp: dict, x: torch.Tensor, enc_out: torch.Tensor, cfg,
              positions: torch.Tensor, cache: Optional[dict],
              q_chunk: int = 0, cons=None, dist: Optional[dict] = None,
              specs=None) -> tuple:
    """One decoder layer: causal self-attention (with its cache), then
    cross-attention to the encoder states, then the biased MLP."""
    lp = fsdp_gather(lp, dist, specs)
    h = layer_norm(x, lp["ln1"]["w"], lp["ln1"]["b"])
    a, nc = attention_block(lp["self_attn"], h, positions=positions,
                            rope_theta=0.0, causal=True, cache=cache,
                            q_chunk=q_chunk, cons=cons, dist=dist)
    x = x + a
    h = layer_norm(x, lp["ln_x"]["w"], lp["ln_x"]["b"])
    a, _ = attention_block(lp["cross_attn"], h, positions=positions,
                           rope_theta=0.0, causal=False, x_kv=enc_out,
                           q_chunk=q_chunk, cons=cons, dist=dist)
    x = x + a
    h = layer_norm(x, lp["ln2"]["w"], lp["ln2"]["b"])
    x = x + mlp(lp["mlp"], h, cfg.mlp_act, Region(dist, "dff_tp"))
    return (x if cons is None else cons.hidden(x)), nc


def _pos_embed(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Sinusoidal embedding of arbitrary positions [S], in f32 on the
    positions' device (the reference's own formula, beside
    ``sinusoidal_positions``' table)."""
    dim = torch.arange(d // 2, dtype=torch.float32, device=positions.device)
    inv = 1.0 / (10000 ** (dim / max(d // 2 - 1, 1)))
    ang = positions.float()[:, None] * inv[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
