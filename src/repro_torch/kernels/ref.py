"""Plain PyTorch versions of the port's kernels.

Each function here is the semantic ground truth its hand-written Hopper
kernel is held against (on the card), and the version a wrapper runs for
a tensor that lies on the CPU.  Written for clarity, not speed.
``swiglu_ref`` and ``rmsnorm_matmul_ref`` of the JAX package's
``kernels/ref.py`` oracle no kernel, and are not carried.
"""
from __future__ import annotations

import torch


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[M, K] @ [K, N] -> [M, N] with f32 accumulation, in a.dtype."""
    return torch.matmul(a.float(), b.float()).to(a.dtype)


def _flash_scores(q: torch.Tensor, k: torch.Tensor, causal: bool,
                  window: int, softcap: float):
    """(f32 scores [B, Hkv, g, T, S] scaled, capped and masked to -1e30,
    the capped scores before masking, the [T, S] mask)."""
    B, T, H, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    qg = q.reshape(B, T, Hkv, H // Hkv, hd)
    scores = torch.einsum("btkgh,bskh->bkgts", qg.float(),
                          k.float()) * (hd ** -0.5)
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap
    q_pos = torch.arange(T, device=q.device) + (S - T)
    kv_pos = torch.arange(S, device=q.device)
    mask = torch.ones((T, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kv_pos[None, :] <= q_pos[:, None]
    if window:
        mask &= kv_pos[None, :] > q_pos[:, None] - window
    masked = torch.where(mask, scores, torch.full_like(scores, -1e30))
    return masked, scores, mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0,
                        softcap: float = 0.0) -> torch.Tensor:
    """Reference GQA attention.

    q: [B, T, H, hd]; k/v: [B, S, Hkv, hd] with H % Hkv == 0 (any
    strides).  causal assumes q positions are S-T..S-1 (suffix of the kv
    sequence).  window: sliding-window size (0 = unlimited).  Returns
    [B, T, H, hd] in q.dtype.
    """
    return _attend(_flash_scores(q, k, causal, window, softcap)[0], q, v)


def _attend(scores: torch.Tensor, q: torch.Tensor,
            v: torch.Tensor) -> torch.Tensor:
    """softmax(scores) v, [B, Hkv, g, T, S] -> [B, T, H, hd] in q.dtype."""
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgts,bskh->btkgh", probs, v.float())
    return out.reshape(q.shape).to(q.dtype)


def flash_attention_fwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, causal: bool = True,
                            window: int = 0, softcap: float = 0.0):
    """:func:`flash_attention_ref` and each row's natural log-sum-exp of
    its masked scores: (out [B, T, H, hd] in q.dtype, lse [B, H, T] f32),
    head h = kv head * g + group index, as the kernels lay it out."""
    B, T, H, _ = q.shape
    scores = _flash_scores(q, k, causal, window, softcap)[0]
    return (_attend(scores, q, v),
            torch.logsumexp(scores, dim=-1).reshape(B, H, T))


def flash_attention_split_ref(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, split_keys: int,
                              causal: bool = True, window: int = 0,
                              softcap: float = 0.0):
    """:func:`flash_attention_fwd_ref` in the split-KV form the forward's
    split route computes: the keys any query sees, ``[k_begin, S)`` with
    ``k_begin`` the first query's window edge (0 without a window), cut
    into runs of ``split_keys`` keys from ``k_begin``; for each run and
    query row the max m of its visible scores (-1e30 where it has none),
    l = sum exp(s - m) and the unnormalised accumulator; then the runs
    merged in split order, M = max m, out = sum acc exp(m - M) / sum l
    exp(m - M), lse = M + log(sum l exp(m - M)).  A row that sees no key
    gets exact zeros and lse -1e30, as the kernels give (the dense plain
    version gives such a row the mean of v).  Returns (out [B, T, H, hd]
    in q.dtype, lse [B, H, T] f32).  Used by nothing on the main path: it
    is the plain version of the kernel's arithmetic."""
    B, T, H, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    _, scores, mask = _flash_scores(q, k, causal, window, softcap)
    k_begin = max(0, S - T - window + 1) if window > 0 else 0
    v = v.float()
    parts = []
    for k0 in range(k_begin, max(S, k_begin + 1), split_keys):
        sl = slice(k0, min(S, k0 + split_keys))
        sc, mk = scores[..., sl], mask[:, sl]
        m = torch.where(mk, sc, torch.full_like(sc, -1e30)).amax(-1)
        p = torch.where(mk, torch.exp(sc - m[..., None]),
                        torch.zeros_like(sc))
        parts.append((m, p.sum(-1),
                      torch.einsum("bkgts,bskh->bkgth", p, v[:, sl])))
    big = torch.stack([m for m, _, _ in parts]).amax(0)
    den = torch.zeros_like(big)
    num = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:                    # in split order
        w = torch.exp(m - big)
        den = den + l * w
        num = num + acc * w[..., None]
    seen = den > 0
    out = torch.where(seen[..., None],
                      num / torch.where(seen, den, 1.0)[..., None],
                      torch.zeros_like(num))
    lse = torch.where(seen, big + torch.log(torch.where(seen, den, 1.0)),
                      torch.full_like(big, -1e30))
    return (out.permute(0, 3, 1, 2, 4).reshape(B, T, H, hd).to(q.dtype),
            lse.reshape(B, H, T))


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, out: torch.Tensor,
                            lse: torch.Tensor, dout: torch.Tensor,
                            causal: bool = True, window: int = 0,
                            softcap: float = 0.0):
    """The flash backward written out in tensors (no autograd), from the
    forward's residuals: D = rowsum(dout * out); P = exp(S - lse), 0
    where masked; dV = P^T dout; dP = dout v^T; dS = P (dP - D), times
    1 - tanh^2 under a softcap; dQ = scale dS k; dK = scale dS^T q (summed
    over the g query heads of each kv head).  All in f32; returns (dq,
    dk, dv) in the dtypes of q, k, v.  A causal row with no visible key
    (S < T) gets P = 0, so its gradients are 0, as for the kernel's zero
    output there (autograd through :func:`flash_attention_ref` differs on
    such rows: its output is the mean of v)."""
    B, T, H, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    scale = hd ** -0.5
    _, capped, mask = _flash_scores(q, k, causal, window, softcap)
    p = torch.where(mask, torch.exp(capped - lse.float().reshape(
        B, Hkv, g, T, 1)), torch.zeros_like(capped))
    qg = q.reshape(B, T, Hkv, g, hd).float()
    dog = dout.reshape(B, T, Hkv, g, hd).float()
    d = (dog * out.reshape(B, T, Hkv, g, hd).float()).sum(-1)  # [B,T,Hkv,g]
    dv = torch.einsum("bkgts,btkgh->bskh", p, dog)
    dp = torch.einsum("btkgh,bskh->bkgts", dog, v.float())
    ds = p * (dp - d.permute(0, 2, 3, 1)[..., None])
    if softcap:
        ds = ds * (1 - (capped / softcap) ** 2)
    dq = torch.einsum("bkgts,bskh->btkgh", ds, k.float()) * scale
    dk = torch.einsum("bkgts,btkgh->bskh", ds, qg) * scale
    return (dq.reshape(B, T, H, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _paged_mask(q: torch.Tensor, lens: torch.Tensor, S: int,
                kv_lens, window: int = 0) -> torch.Tensor:
    """[B, T, S] keys each query may see: query t of row b sits at
    ``lens[b] - T + t`` and sees the keys at or before it (one comparison
    for causality and the row's extent; ``kv_pos < S`` bounds it by the
    table), and below ``kv_lens[b]`` when given: the keys the row has
    written; with a ``window``, only the last ``window`` of them."""
    T = q.shape[1]
    q_pos = (lens.long()[:, None] - T
             + torch.arange(T, device=q.device)[None, :])        # [B, T]
    kv_pos = torch.arange(S, device=q.device)
    mask = kv_pos[None, None, :] <= q_pos[:, :, None]           # [B, T, S]
    if kv_lens is not None:
        mask &= kv_pos[None, None, :] < kv_lens.long()[:, None, None]
    if window:
        mask &= kv_pos[None, None, :] > q_pos[:, :, None] - window
    return mask


def _ring_keys(q, k_pages, v_pages, block, lens, kv_lens, ring: int,
               window: int):
    """A ring of ``ring`` slots read with wrap-around, in logical order.

    The row's count ``n`` is ``kv_lens`` (or ``lens`` without it); the
    ring holds its positions ``[max(0, n - ring), n)``, position p at
    slot ``p % ring`` of the row's pages.  Returns (k, v [B, ring, Hkv,
    hd] with key j of row b the position ``max(0, n - ring) + j``, the
    [B, T, ring] mask: below n, at or before the query, and within its
    ``window``)."""
    B, T = q.shape[:2]
    ps = k_pages.shape[1]
    n = (lens if kv_lens is None else kv_lens).long()
    lo = torch.clamp(n - ring, min=0)
    pos = lo[:, None] + torch.arange(ring, device=q.device)       # [B, ring]
    slot = pos % ring
    page = torch.gather(block.long(), 1, slot // ps)
    off = slot % ps
    k, v = k_pages[page, off], v_pages[page, off]
    q_pos = (lens.long()[:, None] - T
             + torch.arange(T, device=q.device)[None, :])        # [B, T]
    mask = ((pos[:, None, :] < n[:, None, None])
            & (pos[:, None, :] <= q_pos[:, :, None]))
    if window:
        mask &= pos[:, None, :] > q_pos[:, :, None] - window
    return k, v, mask


def _check_ring(block, k_pages, ring: int) -> None:
    if ring < 0 or ring > block.shape[1] * k_pages.shape[1]:
        raise ValueError(f"paged_attention: ring {ring} is not within the "
                         f"table's {block.shape[1] * k_pages.shape[1]} "
                         "slots")


def _paged_keys(q, k_pages, v_pages, block, lens, kv_lens, ring: int,
                window: int):
    """(k, v [B, S, Hkv, hd], mask [B, T, S]) of a paged read: the dense
    gather of each row's pages in table order, or, with a ``ring``, the
    ring's slots in logical order (:func:`_ring_keys`)."""
    if ring:
        _check_ring(block, k_pages, ring)
        return _ring_keys(q, k_pages, v_pages, block, lens, kv_lens, ring,
                          window)
    B, _, _, hd = q.shape
    page_size, Hkv = k_pages.shape[1], k_pages.shape[2]
    S = block.shape[1] * page_size
    blk = block.long()
    k = k_pages[blk].reshape(B, S, Hkv, hd)        # the dense gather
    v = v_pages[blk].reshape(B, S, Hkv, hd)
    return k, v, _paged_mask(q, lens, S, kv_lens, window)


def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, block: torch.Tensor,
                        lens: torch.Tensor, softcap: float = 0.0,
                        kv_lens=None, ring: int = 0,
                        window: int = 0) -> torch.Tensor:
    """Reference paged attention: dense gather through the block table.

    q: [B, T, H, hd] — the T newest tokens per row (KV already written;
    q token t sits at absolute position ``lens[b] - T + t``).
    k_pages/v_pages: [n_pages, page_size, Hkv, hd] (one layer's pool
    view, any strides); block: [B, P] int32 position-ordered page ids;
    lens: [B] int32 true kv extent per row; kv_lens: optional [B] int32
    count of keys each row has written (keys at or past it are masked).
    ring: 0, or the slots of a ring read with wrap-around: the row's
    count is n = kv_lens (lens without it), its keys the positions
    ``[max(0, n - ring), n)``, position p at slot ``p % ring`` of its
    pages.  window: 0, or the keys a query sees at most, its own
    included (a key at p is seen from q when ``q - window < p <= q``).
    This is the copy-in path the kernel deletes: materialize each row's
    pages contiguously, then attend.  Returns [B, T, H, hd] in q.dtype,
    zeros for a query that sees no key.
    """
    B, T, H, hd = q.shape
    Hkv = k_pages.shape[2]
    k, v, mask = _paged_keys(q, k_pages, v_pages, block, lens, kv_lens,
                             ring, window)
    g = H // Hkv
    qg = q.reshape(B, T, Hkv, g, hd)
    scores = torch.einsum("btkgh,bskh->bkgts", qg.float(),
                          k.float()) * (hd ** -0.5)
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap
    scores = torch.where(mask[:, None, None], scores,
                         torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    # Fully-masked (idle) rows: every score is -1e30, softmax degrades
    # to uniform garbage — zero it so idle rows return 0 like the kernel.
    any_valid = mask.any(dim=-1)[:, None, None, :, None]
    probs = torch.where(any_valid, probs, torch.zeros_like(probs))
    out = torch.einsum("bkgts,bskh->btkgh", probs, v.float())
    return out.reshape(B, T, H, hd).to(q.dtype)


def paged_attention_split_ref(q: torch.Tensor, k_pages: torch.Tensor,
                              v_pages: torch.Tensor, block: torch.Tensor,
                              lens: torch.Tensor, split_keys: int,
                              softcap: float = 0.0,
                              kv_lens=None, ring: int = 0,
                              window: int = 0) -> torch.Tensor:
    """:func:`paged_attention_ref` in the split-KV form the kernel's split
    route computes: the row's keys (the P * page_size positions, or a
    ring's ``ring`` in logical order) cut into runs of ``split_keys``
    keys; for each run and row, the max m of its visible scores (-1e30
    where it has none), l = sum exp(s - m) and the unnormalised
    accumulator; then the runs merged in split order, M = max m, out =
    sum acc exp(m - M) / sum l exp(m - M), or 0 where that sum is 0 (a
    query that sees no key).  Used by nothing on the main path: it is the
    plain version of the kernel's arithmetic, tested on the CPU against
    the JAX reference."""
    B, T, H, hd = q.shape
    Hkv = k_pages.shape[2]
    g = H // Hkv
    k, v, mask = _paged_keys(q, k_pages, v_pages, block, lens, kv_lens,
                             ring, window)
    S = k.shape[1]
    k, v = k.float(), v.float()
    qg = q.reshape(B, T, Hkv, g, hd).float()
    scores = torch.einsum("btkgh,bskh->bkgts", qg, k) * (hd ** -0.5)
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap
    mask = mask[:, None, None]
    parts = []
    for k0 in range(0, S, split_keys):
        sl = slice(k0, min(S, k0 + split_keys))
        sc, mk = scores[..., sl], mask[..., sl]
        m = torch.where(mk, sc, torch.full_like(sc, -1e30)).amax(-1)
        p = torch.where(mk, torch.exp(sc - m[..., None]),
                        torch.zeros_like(sc))
        parts.append((m, p.sum(-1),
                      torch.einsum("bkgts,bskh->bkgth", p, v[:, sl])))
    big = torch.stack([m for m, _, _ in parts]).amax(0)
    den = torch.zeros_like(big)
    num = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:                    # in split order
        w = torch.exp(m - big)
        den = den + l * w
        num = num + acc * w[..., None]
    out = torch.where(den[..., None] > 0,
                      num / torch.where(den > 0, den, 1.0)[..., None],
                      torch.zeros_like(num))
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, H, hd).to(q.dtype)
