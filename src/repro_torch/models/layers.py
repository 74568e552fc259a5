"""Shared transformer layers: norms, RoPE, GQA attention, SwiGLU MLP.

All layers are plain functions over explicit parameter dicts of tensors,
with the JAX package's layouts (``wq [d, nh, hd]``, ``wo [nh, hd, d]``,
...) so converted weights drop in unchanged.  Attention has two modes
here: no cache, and the paged branch, whose read goes through
``ops.paged_attention`` — the Hopper kernel on CUDA, its plain version
on the CPU.  The dense ring-cache branch of the JAX package waits for a
later slice.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def rms_norm(scale: torch.Tensor, x: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * scale.float()).to(dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: [..., seq] (broadcastable)."""
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    angle = positions[..., :, None].float() * freq     # [..., seq, half]
    cos = torch.cos(angle)[..., :, None, :]              # broadcast over heads
    sin = torch.sin(angle)[..., :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA self-attention, optional paged KV cache)
# ---------------------------------------------------------------------------
def is_paged(cache) -> bool:
    """A *paged* cache view: the KV pool's page arrays plus a per-row
    block table, instead of a dense per-slot ring.

    ``pages_k``/``pages_v`` are the pool's whole store ``[n_pages + 1,
    ps, L, Hkv, hd]``: the last page is a write sink that no block table
    names.  Writes a ``write_mask`` disables are sent there, which is how
    the JAX package's out-of-range index + ``mode="drop"`` scatter is
    expressed without a device-to-host sync."""
    return isinstance(cache, dict) and "pages_k" in cache


def attention(p: Dict[str, Any], cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor,
              cache: Optional[Dict[str, Any]] = None,
              cache_pos: Optional[torch.Tensor] = None,
              write_mask: Optional[torch.Tensor] = None,
              ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """GQA self-attention.

    x: [B, T, D]; positions: [B, T] absolute positions of x tokens.
    cache/cache_pos: a paged cache (:func:`is_paged`, with ``layer`` set)
        and the [B] write position of each row; None for no cache.
    write_mask: [B, T] bool, per-token cache-write validity: masked
        tokens are not written to any page another row can read.

    Returns (out [B,T,D], the cache (updated in place) or None).
    """
    T = x.shape[1]
    q = torch.einsum("btd,dhk->bthk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qk_norm:
        q = rms_norm(p["q_norm"], q, cfg.norm_eps)
        k = rms_norm(p["k_norm"], k, cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    if cache is not None:
        if not is_paged(cache):
            raise NotImplementedError(
                "dense ring KV caches are not ported yet (ROADMAP: dense-"
                "ring attention branch); use a paged cache")
        if cfg.sliding_window:
            raise NotImplementedError("a sliding window defeats the linear "
                                      "position->page mapping")
        kp, vp = cache["pages_k"], cache["pages_v"]
        li, blockt = cache["layer"], cache["block"]
        ps = kp.shape[1]
        sink = kp.shape[0] - 1
        cp = cache_pos
        if cp is None or cp.dim() != 1:
            raise ValueError("paged cache requires a [B] vector cache_pos "
                             "(per-row block tables)")
        cp = cp.long()
        idx = cp[:, None] + torch.arange(T, device=x.device)     # [B, T]
        col = torch.clamp(idx // ps, max=blockt.shape[1] - 1)    # mode="clip"
        page = torch.gather(blockt, 1, col).long()
        off = idx % ps
        if write_mask is not None:
            page = torch.where(write_mask, page, torch.full_like(page, sink))
        # In place, through the layer's strided view of the shared pool.
        kp[:, :, li].index_put_((page, off), k.to(kp.dtype))
        vp[:, :, li].index_put_((page, off), v.to(vp.dtype))
        # Query t sits at lens-T+t, so lens = cache_pos + T (not the
        # written count): each valid query t attends k_pos <= cp+t.
        lens = (cp + T).to(torch.int32)
        out = ops.paged_attention(q, kp[:, :, li], vp[:, :, li], blockt,
                                  lens, softcap=cfg.attn_logit_softcap)
    else:
        out = _attend_causal(cfg, q, k, v, positions)
    out = torch.einsum("bthk,hkd->btd", out, p["wo"])
    return out, cache


def _attend_causal(cfg: ModelConfig, q, k, v, positions):
    """Cache-less causal GQA attention over the T tokens themselves."""
    B, T, nh, hd = q.shape
    nkv = k.shape[2]
    group = nh // nkv
    qg = q.reshape(B, T, nkv, group, hd)
    scores = torch.einsum("btkgh,bskh->bkgts", qg.float(),
                          k.float()) * (hd ** -0.5)
    softcap = cfg.attn_logit_softcap
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap
    mask = positions[:, None, :] <= positions[:, :, None]        # [B, T, S]
    window = cfg.sliding_window
    if window:
        mask &= positions[:, None, :] > positions[:, :, None] - window
    scores = torch.where(mask[:, None, None], scores,
                         torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgts,bskh->btkgh", probs, v)
    return out.reshape(B, T, nh, hd)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------
def mlp(p: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    h = F.silu(torch.einsum("btd,df->btf", x, p["wi_gate"]))
    h = h * torch.einsum("btd,df->btf", x, p["wi_up"])
    return torch.einsum("btf,fd->btd", h, p["wo"])


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------
def embed(p: Dict[str, Any], tokens: torch.Tensor,
          cfg: ModelConfig) -> torch.Tensor:
    return p["table"][tokens.long()].to(cfg.compute_dtype)


def unembed_matrix(p: Dict[str, Any], cfg: ModelConfig) -> torch.Tensor:
    """Returns W_out [d_model, vocab]."""
    if cfg.tie_embeddings:
        return p["table"].T
    return p["unembed"]
