"""Shared transformer layers: norms, RoPE, GQA attention, SwiGLU MLP.

All layers are plain functions over explicit parameter dicts of tensors,
with the JAX package's layouts (``wq [d, nh, hd]``, ``wo [nh, hd, d]``,
...) so converted weights drop in unchanged.  Attention has three modes
here: no cache (training); the paged branch; and the dense ring, a
private ``[B, size, Hkv, hd]`` cache per layer.  Every read goes through
a kernel (``ops`` — the Hopper kernel on CUDA, its plain version on the
CPU): ``ops.flash_attention_trainable`` over the tokens themselves
without a cache (non-causal over a cross-attention source, without RoPE),
``ops.flash_attention`` non-causal over static cross K/V
(:func:`attend_static`), ``ops.flash_attention`` over the written ring
prefix for
a scalar ``cache_pos`` (prefill, lockstep wave decode),
``ops.paged_attention`` over the ring viewed as identity-mapped pages for
a ``[B]`` one.  A sliding-window ring (gemma's local layers) wraps: once a
row passes its size the slots no longer follow position order, and those
reads take the paged kernel's ring bound (:func:`_dense_ring`).

Every query sees exactly the keys the JAX package lets it see: keys at or
before its own position and, under a ``write_mask``, below the count the
row has written (:func:`written_lens`); in a ring, only the positions it
still holds, and within the window.  A row that has written nothing, or
a query whose range is empty, sees no key at all; the reference's
softmax over its all-masked scores is uniform, and :func:`_fill_unseen`
gives it that value.  Such rows (idle
slots, rows not chunking this dispatch) feed nothing back in the uniform
family, but a mixture-of-experts layer routes every token of the
dispatch, so their hidden states decide which live choices keep their
expert's capacity.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import shard


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
# Attention (GQA self / cross, optional paged KV cache)
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


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  window: int = 0, device=None) -> Dict[str, torch.Tensor]:
    """Ring-buffer KV cache for one layer: ``k``/``v`` of ``[batch, size,
    Hkv, hd]`` zeros in the compute dtype, ``size = min(window,
    max_len)`` or ``max_len``."""
    size = min(window, max_len) if window else max_len
    kv = (batch, size, cfg.num_kv_heads, cfg.head_dim_)
    return {n: torch.zeros(kv, dtype=cfg.compute_dtype, device=device)
            for n in ("k", "v")}


def ring_page_size(size: int) -> int:
    """Page size of the identity-page view of a ``size``-slot ring: the
    largest power of two up to 64 that divides it, so the view is exact."""
    return math.gcd(size, 64)


def attention(p: Dict[str, Any], cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor, window: int = 0,
              cache: Optional[Dict[str, Any]] = None,
              cache_pos=None,
              write_mask: Optional[torch.Tensor] = None,
              kv_source: Optional[torch.Tensor] = None,
              ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """GQA self- or cross-attention.

    x: [B, T, D]; positions: [B, T] absolute positions of x tokens.
    window: sliding-window size (0 = global causal).
    kv_source: cross-attention source [B, S, D] (no cache): K/V are
        projected from it, neither q nor k takes RoPE and no key is
        masked, the JAX package's ``kv_source`` (``layers.py:143-175,
        314-329`` there).  The whisper encoder passes its own normed
        input, which makes its self-attention bidirectional.  It runs
        through ``ops.flash_attention_trainable(..., causal=False)``.
    cache/cache_pos: None for no cache; a paged cache (:func:`is_paged`,
        with ``layer`` set) and the [B] write position of each row; or a
        dense ring ``{"k", "v"}`` of one layer with either a Python int
        (the whole batch in lockstep: prefill, wave decode) or a [B]
        tensor (per-row slots), plus the ring's constant identity block
        table ``block`` [B, size / ring_page_size(size)] for reads through
        the paged kernel (all but an unwrapped lockstep one).
    write_mask: [B, T] bool, per-token cache-write validity (needs a [B]
        ``cache_pos``): masked tokens write nothing another row can read
        (paged) or keep the ring's old value (dense).

    Returns (out [B,T,D], the cache (updated in place) or None).
    """
    T = x.shape[1]
    cross = kv_source is not None
    kv_in = kv_source if cross else x
    q = torch.einsum("btd,dhk->bthk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", kv_in, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", kv_in, p["wv"])
    if cfg.qk_norm:
        q = rms_norm(p["q_norm"], q, cfg.norm_eps)
        k = rms_norm(p["k_norm"], k, cfg.norm_eps)
    q = shard(q, "batch", "seq", "heads", "head_dim")
    kv_seq = "cache_seq" if cache is not None else "seq"
    k = shard(k, "batch", kv_seq, "kv_heads", "head_dim")
    v = shard(v, "batch", kv_seq, "kv_heads", "head_dim")
    if cross:
        if cache is not None:
            raise ValueError("cross-attention reads a static cache "
                             "(attend_static), not a ring")
        out = on_local_heads(ops.flash_attention_trainable, q, k, v,
                             causal=False, softcap=cfg.attn_logit_softcap)
        return _out_proj(out, p["wo"]), None
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    if cache is None:
        # The training path.  Exact only because a cache-less forward's
        # positions are ``start_pos + arange(T)`` on every row
        # (``Model.forward``): the T queries are then the suffix of the T
        # keys, the flash contract, and relative positions mask as the
        # absolute ones would.
        out = on_local_heads(ops.flash_attention_trainable, q, k, v,
                             causal=True, window=window,
                             softcap=cfg.attn_logit_softcap)
    elif is_paged(cache):
        if window:
            raise NotImplementedError("a sliding window defeats the linear "
                                      "position->page mapping")
        out = _paged(cfg, q, k, v, cache, cache_pos, write_mask)
    else:
        out = _dense_ring(cfg, q, k, v, cache, cache_pos, write_mask,
                          window)
    return _out_proj(out, p["wo"]), cache


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    return shard(torch.einsum("bthk,hkd->btd", out, wo),
                 "batch", "seq", "embed")


def on_local_heads(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   **kw) -> torch.Tensor:
    """``fn(q, k, v, **kw)`` (a flash entry point) on this rank's
    shards when q is a DTensor: the kernels take raw device pointers, so
    under a mesh each call gets plain local tensors (``shard_map_compat``,
    the JAX package's ``shard_map``).  Attention is independent across
    the batch and across KV head groups, so q/k/v keep their batch and
    head splits where the rules give them and the sizes divide (q's heads
    and k/v's heads over the same axes, so each rank holds whole groups);
    sequence and head_dim are gathered.  Plain tensors go straight
    through."""
    if not sharding.is_dtensor(q):
        return fn(q, k, v, **kw)
    mesh = q.device_mesh
    b = sharding.batch_entry(q.shape[0], mesh)
    hq = sharding.dividing("heads", q.shape[2], mesh)
    hk = sharding.dividing("kv_heads", k.shape[2], mesh)
    if hq != hk:
        hq = hk = None
    qs = sharding.P(b, None, hq, None)
    kvs = sharding.P(b, None, hk, None)
    return sharding.shard_map_compat(
        lambda q, k, v: fn(q, k, v, **kw), mesh=mesh,
        in_specs=(qs, kvs, kvs), out_specs=qs)(q, k, v)


def _paged(cfg: ModelConfig, q, k, v, cache, cache_pos, write_mask):
    """Paged branch: scatter the T new tokens to (page, offset) in place,
    then attend through the block table."""
    T = q.shape[1]
    kp, vp = cache["pages_k"], cache["pages_v"]
    li, blockt = cache["layer"], cache["block"]
    ps = kp.shape[1]
    sink = kp.shape[0] - 1
    cp = cache_pos
    if not torch.is_tensor(cp) or cp.dim() != 1:
        raise ValueError("paged cache requires a [B] vector cache_pos "
                         "(per-row block tables)")
    cp = cp.long()
    idx = cp[:, None] + torch.arange(T, device=q.device)         # [B, T]
    col = torch.clamp(idx // ps, max=blockt.shape[1] - 1)        # mode="clip"
    page = torch.gather(blockt, 1, col).long()
    off = idx % ps
    if write_mask is not None:
        page = torch.where(write_mask, page, torch.full_like(page, sink))
    # In place, through the layer's strided view of the shared pool.
    kl, vl = kp[:, :, li], vp[:, :, li]
    kl.index_put_((page, off), k.to(kp.dtype))
    vl.index_put_((page, off), v.to(vp.dtype))
    # Query t sits at lens-T+t = cp+t and attends keys <= cp+t that the
    # row has written (kv_lens).
    lens = (cp + T).to(torch.int32)
    kv_lens = written_lens(cp, write_mask)
    out = ops.paged_attention(q, kl, vl, blockt, lens,
                              softcap=cfg.attn_logit_softcap, kv_lens=kv_lens)
    return _fill_unseen(out, vl, blockt, _rows_unseen(kv_lens))


def written_lens(cp: torch.Tensor, write_mask: Optional[torch.Tensor]
                 ) -> Optional[torch.Tensor]:
    """[B] int32 keys each row holds once this dispatch's writes land,
    ``cp + sum(write_mask)``: the JAX package's ``total``, which bounds
    its keys (``layers.py:214-233`` there).  None without a write mask:
    every row then writes all T tokens and ``lens = cp + T`` bounds it.
    Computed on the device; nothing is read back."""
    if write_mask is None:
        return None
    return (cp + write_mask.sum(1)).to(torch.int32)


def _rows_unseen(kv_lens: Optional[torch.Tensor]
                 ) -> Optional[torch.Tensor]:
    """[B, 1] rows that see no key in a read from key 0: those that have
    written none (None without ``kv_lens``: every row sees its own
    token)."""
    return None if kv_lens is None else (kv_lens == 0)[:, None]


def _ring_unseen(cp: torch.Tensor, T: int, n: torch.Tensor, size: int,
                 window: int) -> torch.Tensor:
    """[B, T] queries of a ring read whose range of keys is empty.  Query
    t of row b sits at ``q = cp + t``; the ring holds the positions
    ``[max(0, n - size), n)`` and q sees those in ``[q - window + 1, q]``
    (``window`` 0: no lower bound), the reference's ``slot_pos`` and
    window mask (``layers.py:234-298, 316-327`` there).  Computed on the
    device."""
    q = cp.long()[:, None] + torch.arange(T, device=cp.device)
    n = n.long()[:, None]
    lo = torch.clamp(n - size, min=0)
    if window:
        lo = torch.maximum(lo, q - window + 1)
    return lo > torch.minimum(q, n - 1)


def _fill_unseen(out: torch.Tensor, v_pages: torch.Tensor,
                 block: torch.Tensor, unseen: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """Queries that see no key (``unseen``: [B, T] or [B, 1] bool) get 0
    from the kernel.  The reference masks all their scores to -1e30 and
    its softmax is uniform: their output is the mean of V over the row's
    ``P * ps`` gathered keys (its block table's pages, or every slot of a
    ring, after this dispatch's writes), the mean of its P page means.
    Each page mean is one bag of an ``embedding_bag`` over the layer's V
    viewed as ``(page, token)`` rows: it reads the rows in place and
    builds no ``[B, P * ps]`` gather, and B * P bags keep the card busier
    than B bags of P * ps rows (2.9x less time at olmoe's decode on an
    H100).  Rows with no such query average page 0 instead of their own
    table (cheap, and discarded), since which queries are unseen is known
    only on the device: no host sync."""
    if unseen is None:
        return out
    with record_function("attention.fill_unseen"):
        B, T, H, hd = out.shape
        n, ps, Hkv, _ = v_pages.shape
        P = block.shape[1]
        row = unseen.any(1)                                          # [B]
        blk = torch.where(row[:, None], block, 0).long()             # [B, P]
        rows = blk[:, :, None] * ps + torch.arange(ps, device=out.device)
        page_mean = F.embedding_bag(rows.view(B * P, ps),
                                    v_pages.reshape(n * ps, Hkv * hd),
                                    mode="mean")
        # [B, 1, Hkv, 1, hd], broadcast over T and each kv head's queries.
        mean = page_mean.view(B, 1, P, Hkv, 1, hd).mean(2).to(out.dtype)
        got = out.reshape(B, T, Hkv, H // Hkv, hd)
        return torch.where(unseen[:, :, None, None, None], mean,
                           got).view(B, T, H, hd)


def _write_run(ring: torch.Tensor, new: torch.Tensor, start: int) -> None:
    """Write ``new`` [B, m, ...] (m <= size) into slots ``start, start +
    1, ...`` of every row of ``ring`` [B, size, ...], wrapping at the
    end."""
    size, m = ring.shape[1], new.shape[1]
    first = min(m, size - start)
    ring[:, start:start + first] = new[:, :first]
    ring[:, :m - first] = new[:, first:]


def _dense_ring(cfg: ModelConfig, q, k, v, cache, cache_pos, write_mask,
                window: int = 0):
    """Dense ring branch: write the T new tokens into ring slot
    ``(cp + t) % size`` in place, then attend over the ring.

    Writes follow JAX's CPU scatter: within one dispatch the last write
    to a slot wins, and a masked token writes back the slot's value from
    before the dispatch.  Tokens t and t + size share a slot, so only the
    last ``min(T, size)`` tokens are written (each slot once: CUDA's
    ``index_put_`` leaves duplicates undefined), and a slot whose last
    writer is masked keeps its old value even when an earlier token of
    the dispatch hit it.

    A Python-int ``cache_pos`` writes the same slots for every row.  While
    the ring has not wrapped (``cp + T <= size``) it reads ``ring[:, :cp
    + T]`` through the flash kernel, queries at its suffix (the flash
    contract with ``q_offset = cp``), with the layer's ``window``: the
    reference's lockstep read.  A [B] tensor writes each row at its own
    slots (masked tokens keep the old value through a gather + where) and
    reads the ring as identity-mapped pages through the paged kernel with
    ``lens = cp + T`` and, under a write mask, ``kv_lens`` = the written
    count, as the reference bounds it (``prefill_chunk_into``,
    ``chunked_block``).  Its dense decode loop passes no mask: dead decode
    rows write junk into their own private row and read ``cp + T`` keys,
    in both packages.

    A windowed layer, and a lockstep read past the ring's end, use the
    paged kernel's ring bound: the row holds positions ``[max(0, n -
    size), n)`` (n the written count), position p at slot ``p % size``,
    and query q sees those in ``(q - window, q]``.  A query whose range
    is empty (a row with nothing written, the first ``T - size`` queries
    of a dispatch longer than the ring, a padded tail a window past the
    written keys) gets the uniform average of the row's slots
    (:func:`_fill_unseen`)."""
    B, T = q.shape[:2]
    ck, cv = cache["k"], cache["v"]
    size = ck.shape[1]
    m = min(T, size)
    k_new, v_new = k[:, T - m:].to(ck.dtype), v[:, T - m:].to(cv.dtype)
    if not torch.is_tensor(cache_pos):
        cp = int(cache_pos)
        if write_mask is not None:
            raise ValueError("write_mask requires a [B] vector cache_pos "
                             "(per-row chunked admission)")
        start = (cp + T - m) % size
        _write_run(ck, k_new, start)
        _write_run(cv, v_new, start)
        if cp + T <= size:
            return ops.flash_attention(q, ck[:, :cp + T], cv[:, :cp + T],
                                       causal=True, window=window,
                                       softcap=cfg.attn_logit_softcap)
        # Past the ring's end: B rows that share cp + T, through the ring
        # bound; query t < T - size sees nothing (its positions are gone).
        lens = torch.full((B,), cp + T, dtype=torch.int32, device=q.device)
        kv_lens, ring = None, size
        unseen = (torch.arange(T, device=q.device)
                  < T - size)[None] if T > size else None
    else:
        if cache_pos.dim() != 1:
            raise ValueError("a dense ring needs a Python int or a [B] "
                             "cache_pos")
        cp = cache_pos.long()
        slots = (cp[:, None] + torch.arange(T - m, T, device=q.device)) % size
        b_idx = torch.arange(B, device=q.device)[:, None]
        if write_mask is not None:
            wm = write_mask[:, T - m:, None, None]
            k_new = torch.where(wm, k_new, ck[b_idx, slots])
            v_new = torch.where(wm, v_new, cv[b_idx, slots])
        ck.index_put_((b_idx, slots), k_new)
        cv.index_put_((b_idx, slots), v_new)
        lens = (cp + T).to(torch.int32)
        kv_lens = written_lens(cp, write_mask)
        ring = size if window else 0
        if not ring:
            unseen = _rows_unseen(kv_lens)
        elif write_mask is None and T <= size:
            unseen = None       # n = cp + T: every query holds its own key
        else:
            unseen = _ring_unseen(cp, T, lens if kv_lens is None
                                  else kv_lens, size, window)
    ps = ring_page_size(size)
    Hkv, hd = ck.shape[2], ck.shape[3]
    block = cache["block"]
    vpages = cv.view(B * size // ps, ps, Hkv, hd)
    out = ops.paged_attention(q, ck.view(B * size // ps, ps, Hkv, hd),
                              vpages, block, lens,
                              softcap=cfg.attn_logit_softcap, kv_lens=kv_lens,
                              ring=ring, window=window)
    return _fill_unseen(out, vpages, block, unseen)


def attend_static(p: Dict[str, Any], cfg: ModelConfig, x: torch.Tensor,
                  kv_cache: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Cross-attention of x [B, T, D] against precomputed K/V ``{"k",
    "v"}`` [B, S, Hkv, hd] (:func:`cross_kv`): no RoPE, no mask and no
    softcap, as the JAX package's ``_attend_static`` (``model.py:106-120``
    there).  Any T against any S, through ``ops.flash_attention(...,
    causal=False)``."""
    q = torch.einsum("btd,dhk->bthk", x, p["wq"])
    if cfg.qk_norm:
        q = rms_norm(p["q_norm"], q, cfg.norm_eps)
    out = on_local_heads(ops.flash_attention, q, kv_cache["k"],
                         kv_cache["v"], causal=False)
    return _out_proj(out, p["wo"])


def cross_kv(p: Dict[str, Any], cfg: ModelConfig,
             source: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Cross-attention K/V [B, S, Hkv, hd] of an image or encoder source
    [B, S, D] (``model.py:123-129`` there): ``k_norm`` under
    ``qk_norm``, no RoPE."""
    k = torch.einsum("bsd,dhk->bshk", source, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", source, p["wv"])
    if cfg.qk_norm:
        k = rms_norm(p["k_norm"], k, cfg.norm_eps)
    return {"k": k, "v": v}


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------
def mlp(p: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    h = F.silu(torch.einsum("btd,df->btf", x, p["wi_gate"]))
    h = h * torch.einsum("btd,df->btf", x, p["wi_up"])
    h = shard(h, "batch", "seq", "mlp")
    return shard(torch.einsum("btf,fd->btd", h, p["wo"]),
                 "batch", "seq", "embed")


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------
def embed(p: Dict[str, Any], tokens: torch.Tensor,
          cfg: ModelConfig) -> torch.Tensor:
    """Table rows in the compute dtype; gemma's are scaled by
    ``sqrt(d_model)`` cast to that dtype first (73.5 in bf16 at d 5376),
    as the reference's ``embed`` (``layers.py:396-399`` there)."""
    if sharding.is_dtensor(p["table"]):
        x = _embed_vocab_parallel(p["table"], tokens).to(cfg.compute_dtype)
    else:
        x = p["table"][tokens.long()].to(cfg.compute_dtype)
    if cfg.name.startswith("gemma"):
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                             device=x.device)
    return shard(x, "batch", "seq", "embed")


def _embed_vocab_parallel(table: torch.Tensor,
                          tokens: torch.Tensor) -> torch.Tensor:
    """The lookup of a table split over its vocabulary (rules: "vocab"),
    on local shards: each rank looks up the tokens in its own rows (the
    others give zeros) and one all-reduce over the vocabulary's axis
    joins them.  DTensor's own sharded lookup leaves a masked partial it
    cannot combine with the gradient's partial sum."""
    mesh = table.device_mesh
    v_ax = sharding.spec_for(("vocab", "embed"))[0] \
        if sharding.active() else None
    if not isinstance(v_ax, str):
        v_ax = None                      # gathered whole below
    rows = -(-table.shape[0] // sharding.mesh_axis_size(mesh, v_ax)) \
        if v_ax else table.shape[0]
    b = sharding.batch_entry(tokens.shape[0], mesh)

    def local(tok, tab):
        # Row indexing, as the unsharded lookup, so a one-rank mesh
        # gives its bits (forward and gradient).
        if v_ax is None:
            return tab[tok.long()]
        ids = tok.long() - mesh.get_local_rank(v_ax) * rows
        ok = (ids >= 0) & (ids < tab.shape[0])
        x = tab[torch.where(ok, ids, 0)]
        return sharding.psum(torch.where(ok[..., None], x, 0), mesh, v_ax)

    return sharding.shard_map_compat(
        local, mesh=mesh, in_specs=(sharding.P(b, None),
                                    sharding.P(v_ax, None)),
        out_specs=sharding.P(b, None, None),
        collective_axes=sharding.mesh_axis_names(mesh))(tokens, table)


def unembed_matrix(p: Dict[str, Any], cfg: ModelConfig) -> torch.Tensor:
    """Returns W_out [d_model, vocab]."""
    if cfg.tie_embeddings:
        return p["table"].T
    return p["unembed"]
