"""Vocab-safe cross-entropy and decode-path logits.

``chunked_softmax_xent`` never holds the full ``[tokens, vocab]`` logits:
the hidden states are processed in token chunks, each chunk's logits are
reduced to logsumexp and the label logit at once, and the backward
recomputes them chunk by chunk (``torch.utils.checkpoint``, the
counterpart of the JAX package's ``@jax.checkpoint``), so the logits are
never stacked across chunks.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.parallel.sharding import is_dtensor, shard


def _chunk_xent(hc: torch.Tensor, w_out: torch.Tensor, yc: torch.Tensor,
                wc: torch.Tensor) -> torch.Tensor:
    """Weighted sum of (logsumexp - label logit) over one token chunk;
    w_out [D, V] in float32."""
    if hc.dim() == 3:
        hc = shard(hc, "batch", None, None)
    logits = torch.matmul(hc.float(), w_out)
    logits = shard(logits, *(("batch", None, "vocab") if logits.dim() == 3
                             else (None, "vocab")))
    lse = torch.logsumexp(logits, dim=-1)
    if is_dtensor(logits):
        # A gather along the vocab-sharded dimension gives DTensor a
        # masked partial it cannot combine here; the label's column
        # picked by a mask is the same value (one term, zeros elsewhere).
        cols = torch.arange(logits.shape[-1], device=yc.device)
        ll = torch.where(cols == yc.long()[..., None], logits, 0.0).sum(-1)
    else:
        ll = torch.gather(logits, -1, yc.long()[..., None])[..., 0]
    return torch.sum((lse - ll) * wc)


def _chunk(token_chunk: int, n: int) -> int:
    """The chunk length: ``token_chunk`` at most, halved until it
    divides ``n``."""
    chunk = min(token_chunk, n)
    while n % chunk:
        chunk //= 2
    return chunk


def chunked_softmax_xent(hidden: torch.Tensor, w_out: torch.Tensor,
                         labels: torch.Tensor, token_chunk: int = 2048,
                         weights: Optional[torch.Tensor] = None,
                         layout: str = "flat") -> torch.Tensor:
    """hidden [B, T, D]; w_out [D, V]; labels [B, T] int.

    Returns the mean cross-entropy over all weighted tokens (weights
    default to 1; 0 masks a position, e.g. the last one under rolled
    labels).  The logits are accumulated in float32, as the JAX
    package's ``preferred_element_type=float32`` einsum does.

    ``layout`` (``ModelConfig.xent_layout``) picks the chunk shape, as in
    ``src/repro/models/losses.py:20-96``: ``"flat"`` cuts the ``B*T``
    tokens into chunks; ``"batched"`` cuts along T and keeps the batch
    dimension in every chunk.  On one device both give the same value.
    """
    B, T, D = hidden.shape
    w32 = w_out.float()
    if layout == "batched":
        w = (torch.ones((B, T), dtype=torch.float32, device=hidden.device)
             if weights is None else weights.float())
        h, y = hidden, labels
        c = _chunk(token_chunk, T)
        cuts = [(slice(None), slice(i, i + c)) for i in range(0, T, c)]
    else:
        n = B * T
        h = hidden.reshape(n, D)
        y = labels.reshape(n)
        w = (torch.ones((n,), dtype=torch.float32, device=hidden.device)
             if weights is None else weights.reshape(n).float())
        c = _chunk(token_chunk, n)
        cuts = [(slice(i, i + c),) for i in range(0, n, c)]
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for cut in cuts:
        total = total + checkpoint(_chunk_xent, h[cut], w32, y[cut],
                                   w[cut], use_reentrant=False)
    return total / torch.clamp(torch.sum(w), min=1.0)


def full_logits(hidden: torch.Tensor, w_out: torch.Tensor) -> torch.Tensor:
    """Decode-path logits (tiny T): [B, T, D] -> [B, T, V], accumulated
    and returned in float32 like the JAX package's
    ``preferred_element_type=float32`` einsum."""
    return shard(torch.einsum("btd,dv->btv", hidden.float(), w_out.float()),
                 "batch", None, "vocab")
