"""Plain PyTorch versions of the port's kernels.

Each function here is the semantic ground truth its hand-written Hopper
kernel is held against (on the card), and the version a wrapper runs for
a tensor that lies on the CPU.  Written for clarity, not speed.  The
other oracles of the JAX package's ``kernels/ref.py`` arrive with their
kernels.
"""
from __future__ import annotations

import torch


def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, block: torch.Tensor,
                        lens: torch.Tensor, softcap: float = 0.0
                        ) -> torch.Tensor:
    """Reference paged attention: dense gather through the block table.

    q: [B, T, H, hd] — the T newest tokens per row (KV already written;
    q token t sits at absolute position ``lens[b] - T + t``).
    k_pages/v_pages: [n_pages, page_size, Hkv, hd] (one layer's pool
    view, any strides); block: [B, P] int32 position-ordered page ids;
    lens: [B] int32 true kv extent per row.  This is the copy-in path the
    kernel deletes: materialize each row's pages contiguously, then
    attend.  Returns [B, T, H, hd] in q.dtype.
    """
    B, T, H, hd = q.shape
    page_size, Hkv = k_pages.shape[1], k_pages.shape[2]
    S = block.shape[1] * page_size
    blk = block.long()
    k = k_pages[blk].reshape(B, S, Hkv, hd)        # the dense gather
    v = v_pages[blk].reshape(B, S, Hkv, hd)
    g = H // Hkv
    qg = q.reshape(B, T, Hkv, g, hd)
    scores = torch.einsum("btkgh,bskh->bkgts", qg.float(),
                          k.float()) * (hd ** -0.5)
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap
    ar_t = torch.arange(T, device=q.device)
    q_pos = lens.long()[:, None] - T + ar_t[None, :]            # [B, T]
    kv_pos = torch.arange(S, device=q.device)
    # One comparison covers causality AND the row's true extent:
    # kv_pos <= q_pos <= lens - 1 < S.
    mask = kv_pos[None, None, :] <= q_pos[:, :, None]           # [B, T, S]
    scores = torch.where(mask[:, None, None], scores,
                         torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    # Fully-masked (idle) rows: every score is -1e30, softmax degrades
    # to uniform garbage — zero it so idle rows return 0 like the kernel.
    any_valid = mask.any(dim=-1)[:, None, None, :, None]
    probs = torch.where(any_valid, probs, torch.zeros_like(probs))
    out = torch.einsum("bkgts,bskh->btkgh", probs, v.float())
    return out.reshape(B, T, H, hd).to(q.dtype)
