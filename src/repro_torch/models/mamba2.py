"""Mamba2 (SSD) block, the zamba2 hybrid's sequence mixer (the JAX
package's ``models/mamba2.py``).

in_proj -> [z | xBC | dt]; a causal depthwise conv over xBC; the SSD
recurrence through the shared decay linear attention (scalar decay per
head, one group); a gated RMSNorm; out_proj.  Decode carries the conv
state (the last ``conv_kernel - 1`` inputs of the conv) and the SSM state
[nh, N, head_dim] in float32.  The recurrence runs under the profiler
range ``mamba.ssd``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rms_norm
from repro_torch.parallel.sharding import grad_like, on_local_rows, shard
from repro_torch.models.linear_attention import (
    decay_linear_attention_chunked, decay_linear_attention_scan)

MAMBA_CLAMP = 1.25  # per-step log-decay clamp (fits f32 with chunk 64)


def _dims(cfg: ModelConfig):
    ss = cfg.ssm
    d_in = ss.expand * cfg.d_model
    nh = ss.num_heads or d_in // ss.head_dim
    return ss, d_in, nh


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    """[..., 2 d_in + 2 N + nh] -> z [d_in], xBC [d_in + 2 N], dt [nh]."""
    ss, d_in, nh = _dims(cfg)
    N = ss.state_dim
    return (proj[..., :d_in], proj[..., d_in:2 * d_in + 2 * N],
            proj[..., 2 * d_in + 2 * N:])


def _ssd(p, cfg: ModelConfig, x_heads, Bmat, Cmat, dt, initial_state,
         chunked: bool):
    """x_heads [B, T, nh, hd], Bmat/Cmat [B, T, N], dt [B, T, nh] (after
    softplus) -> (y [B, T, nh, hd], state [B, nh, N, hd])."""
    ss, d_in, nh = _dims(cfg)
    N = ss.state_dim
    a = -torch.exp(p["a_log"].float())                         # [nh], < 0
    ld = (dt * a).unsqueeze(-1).expand(*dt.shape, N)           # log decay
    q = Cmat.unsqueeze(2).expand(*Cmat.shape[:2], nh, N)
    k = Bmat.unsqueeze(2).expand(*Bmat.shape[:2], nh, N)
    v = x_heads * dt.unsqueeze(-1)                             # fold dt in
    with record_function("mamba.ssd"):
        if chunked:
            y, S = on_local_rows(
                decay_linear_attention_chunked, q, k, v, ld, None,
                initial_state, decay_at_readout=True, chunk=ss.chunk,
                clamp=MAMBA_CLAMP)
        else:
            y, S = on_local_rows(
                decay_linear_attention_scan, q, k, v, ld, None,
                initial_state, decay_at_readout=True, clamp=MAMBA_CLAMP)
    y = y + x_heads * p["d_skip"].to(y.dtype)[None, None, :, None]
    return y, S


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype=None,
                     device=None) -> Dict[str, torch.Tensor]:
    """One layer's decode state: ``conv`` [batch, conv_kernel - 1, d_in +
    2 N] in the compute dtype and ``ssm`` [batch, nh, N, head_dim]
    float32, zeros."""
    ss, d_in, nh = _dims(cfg)
    dtype = dtype or cfg.compute_dtype
    return {
        "conv": torch.zeros((batch, ss.conv_kernel - 1,
                             d_in + 2 * ss.state_dim), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, nh, ss.state_dim, ss.head_dim),
                           dtype=torch.float32, device=device),
    }


def mamba2_block(p: Dict[str, Any], cfg: ModelConfig, x: torch.Tensor,
                 cache: Optional[Dict[str, torch.Tensor]] = None,
                 ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """x [B, T, D] -> (out [B, T, D], the new cache or None).  Without a
    cache and with T a multiple of the SSD chunk the recurrence takes the
    chunked form, else the scan (``mamba2.py:116`` there)."""
    ss, d_in, nh = _dims(cfg)
    B, T, _ = x.shape
    proj = grad_like(shard(torch.einsum("btd,de->bte", x, p["in_proj"]),
                           "batch", "seq", "mlp"))
    z, xBC, dt = _split_proj(cfg, proj)
    # softplus as the JAX package's ``jax.nn.softplus``: logaddexp(x, 0).
    dt = torch.logaddexp(dt.float() + p["dt_bias"].float(),
                         torch.zeros((), device=dt.device))

    K = ss.conv_kernel
    if cache is None:
        pad = xBC.new_zeros((B, K - 1, xBC.shape[-1]))
        xBC_seq = torch.cat([pad, xBC], dim=1)
    else:
        xBC_seq = torch.cat([cache["conv"].to(xBC.dtype), xBC], dim=1)
    # Causal depthwise conv (kernel K): the sum of K shifted slices.
    conv = xBC_seq[:, 0:T] * p["conv_w"][0][None, None, :]
    for i in range(1, K):
        conv = conv + xBC_seq[:, i:i + T] * p["conv_w"][i][None, None, :]
    xBC = F.silu(conv + p["conv_b"][None, None, :])

    N = ss.state_dim
    x_in = xBC[..., :d_in].reshape(B, T, nh, ss.head_dim)
    Bmat = xBC[..., d_in:d_in + N]
    Cmat = xBC[..., d_in + N:]

    initial = cache["ssm"] if cache is not None else None
    chunked = cache is None and T % ss.chunk == 0
    y, S = _ssd(p, cfg, x_in, Bmat, Cmat, dt, initial, chunked)
    new_cache = None
    if cache is not None:
        new_cache = {"conv": xBC_seq[:, -(K - 1):], "ssm": S}

    y = y.reshape(B, T, d_in).to(x.dtype)
    # Gated RMSNorm (mamba2-style): norm(y * silu(z)).
    y = rms_norm(p["norm"], y * F.silu(z), cfg.norm_eps)
    return shard(torch.einsum("bte,ed->btd", y, p["out_proj"]),
                 "batch", "seq", "embed"), new_cache
