"""RWKV-6 "Finch" block: data-dependent decay linear attention, no
attention layer (the JAX package's ``models/rwkv6.py``).

Time-mix: token-shift interpolation, r/k/v/gate projections, a per-channel
data-dependent decay w_t from a low-rank MLP (LoRA), the WKV recurrence
through the shared decay linear attention (decay applied after the
readout, with the current-token bonus u), an RMSNorm standing in for the
group norm, and a silu-gated output projection.  Channel-mix: a
token-shifted squared-ReLU MLP (d -> d_ff -> d).

Decode carries ``shift_tm``, ``shift_cm`` (the last token's input of each
mix) and ``wkv`` [nh, hd, hd] float32 per layer.  The recurrence runs
under the profiler range ``rwkv.wkv``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rms_norm
from repro_torch.parallel.sharding import grad_like, on_local_rows, shard
from repro_torch.models.linear_attention import (
    decay_linear_attention_chunked, decay_linear_attention_scan)

RWKV_CLAMP = 5.0  # per-step log-decay clamp; chunk 16 -> 80 nats, f32-safe


def _dims(cfg: ModelConfig):
    hd = cfg.rwkv.head_dim
    return cfg.d_model // hd, hd


def init_rwkv_cache(cfg: ModelConfig, batch: int, dtype=None,
                    device=None) -> Dict[str, torch.Tensor]:
    """One layer's decode state, zeros: the two token shifts [batch, d]
    in the compute dtype and the WKV state [batch, nh, hd, hd] float32."""
    nh, hd = _dims(cfg)
    dtype = dtype or cfg.compute_dtype
    shift = (batch, cfg.d_model)
    return {"shift_tm": torch.zeros(shift, dtype=dtype, device=device),
            "shift_cm": torch.zeros(shift, dtype=dtype, device=device),
            "wkv": torch.zeros((batch, nh, hd, hd), dtype=torch.float32,
                               device=device)}


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """x_{t-1} for x [B, T, D]: zeros, or the cached token, at t = 0."""
    prev = (torch.zeros_like(x[:, :1]) if prev is None
            else prev[:, None, :].to(x.dtype))
    return torch.cat([prev, x[:, :-1]], dim=1)


def _mixer(x: torch.Tensor, xprev: torch.Tensor):
    """``mixed(mix) = x + (x_{t-1} - x) * mix``."""
    delta = xprev - x
    return lambda mix: x + delta * mix[None, None, :].to(x.dtype)


def rwkv6_time_mix(p: Dict[str, Any], cfg: ModelConfig, x: torch.Tensor,
                   cache: Optional[Dict[str, torch.Tensor]] = None):
    """x [B, T, D] -> (out [B, T, D], {"shift_tm", "wkv"} or None).
    Without a cache and with T a multiple of the chunk the recurrence
    takes the chunked form, else the scan (``rwkv6.py:106`` there)."""
    B, T, D = x.shape
    nh, hd = _dims(cfg)
    mixed = _mixer(x, _token_shift(
        x, cache["shift_tm"] if cache is not None else None))
    r = torch.einsum("btd,de->bte", mixed(p["mix_r"]), p["wr"])
    k = torch.einsum("btd,de->bte", mixed(p["mix_k"]), p["wk"])
    v = torch.einsum("btd,de->bte", mixed(p["mix_v"]), p["wv"])
    g = torch.einsum("btd,de->bte", mixed(p["mix_g"]), p["wg"])
    # Data-dependent decay (LoRA): w_t = exp(-exp(w0 + tanh(x A) B)).
    wx = torch.tanh(grad_like(torch.einsum("btd,dr->btr", mixed(p["mix_w"]),
                                           p["w_lora_a"])))
    wlog = (p["w0"].float()[None, None, :]
            + torch.einsum("btr,re->bte", wx, p["w_lora_b"]).float())
    ld = -torch.exp(wlog)                                   # [B, T, D] < 0

    def heads(z):
        return z.reshape(B, T, nh, hd)

    initial = cache["wkv"] if cache is not None else None
    with record_function("rwkv.wkv"):
        if cache is None and T % cfg.rwkv.chunk == 0:
            y, S = on_local_rows(
                decay_linear_attention_chunked, heads(r), heads(k),
                heads(v), heads(ld), p["u_bonus"], initial,
                decay_at_readout=False, chunk=cfg.rwkv.chunk,
                clamp=RWKV_CLAMP)
        else:
            y, S = on_local_rows(
                decay_linear_attention_scan, heads(r), heads(k), heads(v),
                heads(ld), p["u_bonus"], initial, decay_at_readout=False,
                clamp=RWKV_CLAMP)
    y = rms_norm(p["ln_x"], y.reshape(B, T, D), cfg.norm_eps)
    y = y * F.silu(g)
    out = torch.einsum("bte,ed->btd", y, p["wo"])
    new_cache = None
    if cache is not None:
        new_cache = {"shift_tm": x[:, -1], "wkv": S}
    return shard(out, "batch", "seq", "embed"), new_cache


def rwkv6_channel_mix(p: Dict[str, Any], cfg: ModelConfig, x: torch.Tensor,
                      cache: Optional[Dict[str, torch.Tensor]] = None):
    """x [B, T, D] -> (out [B, T, D], {"shift_cm"} or None)."""
    mixed = _mixer(x, _token_shift(
        x, cache["shift_cm"] if cache is not None else None))
    k = torch.einsum("btd,df->btf", mixed(p["cmix_k"]), p["ck"])
    k = shard(torch.square(F.relu(k)), "batch", "seq", "mlp")
    kv = torch.einsum("btf,fd->btd", k, p["cv"])
    r = torch.sigmoid(torch.einsum("btd,de->bte", mixed(p["cmix_r"]),
                                   p["cr"]))
    new_shift = {"shift_cm": x[:, -1]} if cache is not None else None
    return shard(r * kv, "batch", "seq", "embed"), new_shift
