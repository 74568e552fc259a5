"""Model assembly for the uniform-attention (``smollm-135m``),
mixture-of-experts (``olmoe-1b-7b``, ``arctic-480b``) and local:global
(``gemma3-27b``) families.

``build_model(cfg, remat_policy="nothing", device=None)`` returns a
:class:`Model` exposing the JAX package's training and serving surface
over plain parameter dicts of tensors:

  init(generator) -> params
  loss(params, batch) -> (total, {"xent", "aux"})       [training]
  init_cache(batch, max_len) -> dense ring cache
  forward(params, tokens, caches=, cache_pos=, start_pos=, write_mask=)
      -> (hidden, caches, aux)
  prefill(params, tokens, max_len) -> (next_tok [B], fresh dense cache)
  decode_step(params, cache, tokens, pos) -> (next_tok, cache)
  decode_loop(params, cache, cur, pos, rem, eos, k=, max_len=)
      -> (token block [B, k], cache)        [fused packet-mode decode]
  prefill_chunk_into(params, cache, chunk, start, n_valid)
      -> (next_tok [B], cache)     [chunked zero-copy in-place admission]
  chunked_block(...same..., cur, pos, rem, eos, k=, max_len=)
      -> (next_tok, block, cache)  [one dispatch: chunk + K decode steps]

Caches are paged (``layers.is_paged``: the pool's page arrays) or dense
rings (``init_cache``: ``{"k", "v"}`` of ``[L, B, size, Hkv, hd]``, or
for the local:global family the JAX package's tree of local rings of
``min(W, max_len)`` slots and global rings of ``max_len``).  Both are
updated in place, so the returned cache is the one passed in.  A scalar
position (prefill, lockstep wave decode) is a Python int; per-row
positions are a [B] tensor.  The layer stack is a Python loop (the JAX
package's ``lax.scan``); without a cache and with gradients on, each
layer runs under the remat policy.  Entry points
run on CUDA unless ``device="cpu"`` is passed; without a card they raise.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import operator
from typing import Any, Dict, Union

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (attention, embed, init_kv_cache,
                                       is_paged, mlp, ring_page_size,
                                       rms_norm, unembed_matrix)
from repro_torch.models.losses import chunked_softmax_xent, full_logits
from repro_torch.models.moe import moe_block

Params = Dict[str, Any]


def resolve_device(device: Union[str, torch.device, None]) -> torch.device:
    """The port's device rule: CUDA unless the caller asks for another
    device; no silent fallback to the CPU when no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' "
                           "to run on the CPU")
    return dev


def _layer(tree: Any, *idx: int) -> Any:
    """The slice ``idx`` (a layer, or a superblock and its layer) of a
    layer-stacked subtree."""
    if isinstance(tree, dict):
        return {k: _layer(v, *idx) for k, v in tree.items()}
    return tree[idx]


def attn_block(p: Params, cfg: ModelConfig, x, positions, window=0,
               cache=None, cache_pos=None, write_mask=None):
    h = rms_norm(p["ln1"], x, cfg.norm_eps)
    a, cache = attention(p["attn"], cfg, h, positions, window=window,
                         cache=cache, cache_pos=cache_pos,
                         write_mask=write_mask)
    x = x + a
    x = x + mlp(p["mlp"], rms_norm(p["ln2"], x, cfg.norm_eps))
    return x, cache


def moe_layer(p: Params, cfg: ModelConfig, x, positions, cache=None,
              cache_pos=None, write_mask=None):
    """Attention, then the expert mixture (plus arctic's dense residual
    MLP beside it) on the same normed input: (x, cache, aux)."""
    h = rms_norm(p["ln1"], x, cfg.norm_eps)
    a, cache = attention(p["attn"], cfg, h, positions, cache=cache,
                         cache_pos=cache_pos, write_mask=write_mask)
    x = x + a
    h = rms_norm(p["ln2"], x, cfg.norm_eps)
    y, aux = moe_block(p["moe"], cfg, h)
    if "dense" in p:
        y = y + mlp(p["dense"], h)
    return x + y, cache, aux


def _block(p: Params, cfg: ModelConfig, x, positions, window=0, cache=None,
           cache_pos=None, write_mask=None):
    """One layer of any family: (x, cache, aux); aux is None but under
    MoE.  ``window`` is the layer's sliding window (0: global)."""
    if "moe" in p:
        return moe_layer(p, cfg, x, positions, cache, cache_pos, write_mask)
    x, cache = attn_block(p, cfg, x, positions, window, cache, cache_pos,
                          write_mask)
    return x, cache, None


REMAT_POLICIES = ("nothing", "dots", "none")


def _dots_policy(ctx, op, *args, **kwargs):
    """The "dots" policy: keep the outputs of matrix products without
    batch dimensions (the JAX package's
    ``dots_with_no_batch_dims_saveable``), recompute the rest.
    ``torch.einsum`` lowers the projections and the MLP to a ``bmm`` of
    batch 1; attention's products carry batch dimensions."""
    aten = torch.ops.aten
    keep = op in (aten.mm.default, aten.addmm.default) or (
        op is aten.bmm.default and args[0].shape[0] == 1)
    return (CheckpointPolicy.MUST_SAVE if keep
            else CheckpointPolicy.PREFER_RECOMPUTE)


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    device: torch.device
    # What a training forward keeps for the backward (``model.py:304-311``
    # of the JAX package): "nothing" recomputes each layer in the backward
    # (``torch.utils.checkpoint``), "dots" keeps only the matrix products'
    # outputs (selective checkpointing), "none" keeps everything.
    remat_policy: str = "nothing"
    # Identity block tables of dense rings, one per (batch, pages per row).
    _rings: Dict[tuple, torch.Tensor] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    def _structure(self) -> str:
        cfg = self.cfg
        if cfg.encoder is not None:
            return "enc_dec"
        if cfg.rwkv is not None:
            return "uniform_rwkv"
        if cfg.ssm is not None:
            return "zamba_hybrid"
        if cfg.cross_attn_every:
            return "vlm_cross"
        if cfg.moe is not None:
            return "uniform_moe"
        if cfg.local_global_ratio:
            return "gemma_local_global"
        return "uniform_attn"

    def _gemma_plan(self):
        """(local layers per superblock, superblocks, trailing local
        layers), as the JAX package's ``_gemma_plan`` (``model.py:277-282``
        there): (5, 10, 2) for gemma3-27b."""
        per = self.cfg.local_global_ratio
        nsb = self.cfg.num_layers // (per + 1)
        return per, nsb, self.cfg.num_layers - nsb * (per + 1)

    # -- parameters ----------------------------------------------------------
    def init(self, generator: torch.Generator) -> Params:
        """Random weights with the JAX package's distribution
        (``ParamBuilder``): fan-in-scaled normal for projections, unit
        normal for the embedding, ones for norms.  Drawn in float32 on the
        generator's device, then cast to the compute dtype on the model's
        device: every layer-stacked leaf one layer at a time, and an
        embedding table of more than 2^28 entries in pieces of rows, so
        the float32 transient is one layer's (olmoe's whole expert
        ``wi_gate`` would be 8.6 GB, gemma3-27b's ``wi_gate`` stack 28.7
        GB and its table 5.6 GB).  The numbers differ from
        ``jax.random``'s."""
        cfg = self.cfg
        d, f = cfg.d_model, cfg.d_ff
        nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
        dt = cfg.compute_dtype

        def normal(shape, fan_in, scale=None):
            s = fan_in ** -0.5 if scale is None else scale
            x = torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=generator.device) * s
            return x.to(device=self.device, dtype=dt)

        def stacked(lead, shape, fan_in):
            out = torch.empty(lead + shape, dtype=dt, device=self.device)
            for one in out.view((-1,) + shape):
                one.copy_(normal(shape, fan_in))
            return out

        def ones(*shape):
            return torch.ones(shape, dtype=dt, device=self.device)

        def table():
            V = cfg.vocab_size
            rows = max(1, (1 << 28) // d)
            out = torch.empty((V, d), dtype=dt, device=self.device)
            for r0 in range(0, V, rows):
                out[r0:r0 + rows] = normal((min(rows, V - r0), d), 1,
                                           scale=1.0)
            return out

        def attn_layers(*lead):
            attn = {"wq": stacked(lead, (d, nh, hd), d),
                    "wk": stacked(lead, (d, nkv, hd), d),
                    "wv": stacked(lead, (d, nkv, hd), d),
                    "wo": stacked(lead, (nh, hd, d), nh * hd)}
            if cfg.qk_norm:
                attn["q_norm"] = ones(*lead, hd)
                attn["k_norm"] = ones(*lead, hd)
            return {"ln1": ones(*lead, d), "attn": attn,
                    "ln2": ones(*lead, d)}

        def dense_mlp(*lead):
            return {"wi_gate": stacked(lead, (d, f), d),
                    "wi_up": stacked(lead, (d, f), d),
                    "wo": stacked(lead, (f, d), f)}

        emb = {"table": table()}
        if not cfg.tie_embeddings:
            emb["unembed"] = normal((d, cfg.vocab_size), d)
        out = {"embed": emb}
        if self._structure() == "gemma_local_global":
            per, nsb, tail = self._gemma_plan()
            out["super"] = {
                "local": {**attn_layers(nsb, per),
                          "mlp": dense_mlp(nsb, per)},
                "global": {**attn_layers(nsb), "mlp": dense_mlp(nsb)}}
            if tail:
                out["tail"] = {**attn_layers(tail), "mlp": dense_mlp(tail)}
        else:
            L = cfg.num_layers
            layers = attn_layers(L)
            mo = cfg.moe
            if mo is None:
                layers["mlp"] = dense_mlp(L)
            else:
                E, fe = mo.num_experts, mo.d_ff_expert
                layers["moe"] = {"router": stacked((L,), (d, E), d),
                                 "wi_gate": stacked((L,), (E, d, fe), d),
                                 "wi_up": stacked((L,), (E, d, fe), d),
                                 "wo": stacked((L,), (E, fe, d), fe)}
                if mo.dense_residual:
                    layers["dense"] = dense_mlp(L)
            out["layers"] = layers
        out["final_norm"] = ones(d)
        return out

    # -- forward -------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int,
                   device: Union[str, torch.device, None] = None
                   ) -> Dict[str, Any]:
        """Dense ring cache of the whole stack, zeros in the compute
        dtype on ``device`` (the model's by default; "meta" gives the
        shapes alone): ``{"k", "v"}`` of ``[L, batch, size, Hkv, hd]``,
        or for the local:global family the JAX package's tree
        (``model.py:600-606`` there), ``{"super": {"local": [nsb, per,
        ...], "global": [nsb, ...]}, "tail": [tail, ...]}`` of ``{"k",
        "v"}`` rings, local ones of ``min(W, max_len)`` slots and global
        ones of ``max_len``."""
        cfg = self.cfg
        dev = self.device if device is None else device

        def rings(lead, window=0):
            one = init_kv_cache(cfg, batch, max_len, window=window,
                                device=dev)
            return {n: a.new_zeros(lead + tuple(a.shape))
                    for n, a in one.items()}

        if self._structure() != "gemma_local_global":
            return rings((cfg.num_layers,), cfg.sliding_window)
        per, nsb, tail = self._gemma_plan()
        W = cfg.sliding_window
        out = {"super": {"local": rings((nsb, per), W),
                         "global": rings((nsb,))}}
        if tail:
            out["tail"] = rings((tail,), W)
        return out

    def _ring_block(self, batch: int, size: int) -> torch.Tensor:
        """The constant identity block table ``arange(B * P).view(B, P)``
        of a ``[B, size]`` ring viewed as ``size / P``-token pages, built
        once per shape."""
        P = size // ring_page_size(size)
        blk = self._rings.get((batch, P))
        if blk is None:
            blk = torch.arange(batch * P, dtype=torch.int32,
                               device=self.device).view(batch, P)
            self._rings[batch, P] = blk
        return blk

    def _order(self):
        """The layers in order, as (parameter path, cache path, index,
        window): the local:global family runs each superblock's ``per``
        windowed layers, then its global layer with window 0, then the
        windowed tail (``model.py:393-432`` there)."""
        cfg = self.cfg
        if self._structure() != "gemma_local_global":
            return [(("layers",), (), (li,), cfg.sliding_window)
                    for li in range(cfg.num_layers)]
        per, nsb, tail = self._gemma_plan()
        W, local, glob = cfg.sliding_window, ("super", "local"), (
            "super", "global")
        order = []
        for s in range(nsb):
            order += [(local, local, (s, i), W) for i in range(per)]
            order.append((glob, glob, (s,), 0))
        return order + [(("tail",), ("tail",), (i,), W)
                        for i in range(tail)]

    def _stack(self, params: Params, caches):
        """(layer params, its dense ring cache with its identity block
        table or None, its window) for each layer in order."""
        for ppath, cpath, idx, window in self._order():
            c = None
            if caches is not None:
                c = _layer(functools.reduce(operator.getitem, cpath,
                                            caches), *idx)
                c["block"] = self._ring_block(*c["k"].shape[:2])
            yield (_layer(functools.reduce(operator.getitem, ppath, params),
                          *idx), c, window)

    def _remat_block(self, lp: Params, x, positions, window: int):
        """One cache-less layer under the remat policy: (x, aux or
        None)."""
        def block(lp, x, positions):
            x, _, aux = _block(lp, self.cfg, x, positions, window)
            return x, aux

        pol = self.remat_policy
        if pol == "none" or not torch.is_grad_enabled():
            return block(lp, x, positions)
        if pol == "dots":
            ctx = functools.partial(create_selective_checkpoint_contexts,
                                    _dots_policy)
            return checkpoint(block, lp, x, positions, use_reentrant=False,
                              context_fn=ctx)
        return checkpoint(block, lp, x, positions, use_reentrant=False)

    def _run_stack(self, params: Params, x, positions, caches, cache_pos,
                   write_mask=None):
        """-> (hidden, caches, aux): aux sums the layers' load-balance
        losses (0 but under MoE)."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if caches is not None and is_paged(caches):
            for li in range(self.cfg.num_layers):
                x, _, a = _block(_layer(params["layers"], li), self.cfg, x,
                                 positions, cache={**caches, "layer": li},
                                 cache_pos=cache_pos, write_mask=write_mask)
                if a is not None:
                    aux = aux + a
            return x, caches, aux
        for lp, c, window in self._stack(params, caches):
            if c is None:
                x, a = self._remat_block(lp, x, positions, window)
            else:
                x, _, a = _block(lp, self.cfg, x, positions, window, cache=c,
                                 cache_pos=cache_pos, write_mask=write_mask)
            if a is not None:
                aux = aux + a
        return x, caches, aux

    def forward(self, params: Params, tokens: torch.Tensor, caches=None,
                cache_pos=None, start_pos=None, write_mask=None):
        """tokens [B, T] -> (final hidden [B, T, D], caches, aux)."""
        cfg = self.cfg
        B, T = tokens.shape
        ar = torch.arange(T, device=tokens.device)
        if start_pos is None:
            positions = ar.expand(B, T)
        else:
            positions = torch.broadcast_to(start_pos + ar, (B, T))
        x = embed(params["embed"], tokens, cfg)
        x, caches, aux = self._run_stack(params, x, positions, caches,
                                         cache_pos, write_mask=write_mask)
        return rms_norm(params["final_norm"], x, cfg.norm_eps), caches, aux

    def loss(self, params: Params, batch: Dict[str, torch.Tensor]):
        """batch {"tokens": [B, T]} -> (total, {"xent", "aux"}).

        As ``model.py:556-576`` of the JAX package: the forward runs on
        all T tokens with the labels rolled left and the last position
        weighted 0, and the cross-entropy is chunked over the tied (or
        separate) unembedding in the compute dtype.  The total adds
        ``cfg.moe.aux_loss_weight`` times the layers' summed load-balance
        loss for the MoE family (``model.py:575`` there); the uniform
        family's aux is 0.
        """
        cfg = self.cfg
        tokens = batch["tokens"]
        hidden, _, aux = self.forward(params, tokens)
        w_out = unembed_matrix(params["embed"], cfg).to(cfg.compute_dtype)
        labels = torch.roll(tokens, -1, 1)
        weights = torch.ones(tokens.shape, dtype=torch.float32,
                             device=tokens.device)
        weights[:, -1] = 0.0
        xent = chunked_softmax_xent(hidden, w_out, labels, weights=weights,
                                    layout=cfg.xent_layout)
        total = (xent + cfg.moe.aux_loss_weight * aux) if cfg.moe else xent
        return total, {"xent": xent, "aux": aux}

    def _greedy(self, params: Params, hidden: torch.Tensor) -> torch.Tensor:
        """hidden [B, 1, D] -> greedy next token [B] int32."""
        w_out = unembed_matrix(params["embed"], self.cfg).to(
            self.cfg.compute_dtype)
        logits = full_logits(hidden, w_out)
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)

    # -- serving -------------------------------------------------------------
    def decode_step(self, params: Params, caches, tokens: torch.Tensor,
                    pos, write_mask=None):
        """tokens: [B, 1]; pos: absolute position — a Python int (lockstep
        wave decode over a dense ring) or a [B] tensor (per-row; the paged
        backend needs it).  ``write_mask`` [B, 1] gates the cache write per
        row (paged; dense rows keep their junk in their own rows).
        Greedy."""
        start = pos[:, None] if torch.is_tensor(pos) else pos
        hidden, caches, _ = self.forward(
            params, tokens, caches=caches, cache_pos=pos, start_pos=start,
            write_mask=write_mask)
        return self._greedy(params, hidden[:, -1:]), caches

    def prefill(self, params: Params, tokens: torch.Tensor, max_len: int):
        """Process whole prompts [B, T] into a fresh dense ring cache of
        ``max_len`` positions; returns (greedy next token [B], cache).
        Attention is the flash kernel's causal prefill on CUDA."""
        caches = self.init_cache(tokens.shape[0], max_len)
        hidden, caches, _ = self.forward(params, tokens, caches=caches,
                                         cache_pos=0, start_pos=0)
        return self._greedy(params, hidden[:, -1:]), caches

    def decode_loop(self, params: Params, caches, cur, pos, rem, eos, *,
                    k: int, max_len: int):
        """Fused ``k``-step greedy decode emitting a whole token block.

        cur/pos/rem/eos are [B] int32 device tensors (last emitted token,
        tokens written per row, tokens each row may still emit, per-row
        stop token or -1).  A row dies after its EOS, its last allowed
        token, or at ``max_len``; dead rows emit -1, stop advancing and
        write nothing.  The alive/rem/pos masks stay on the device: the
        loop never syncs with the host.  Returns (block [B, k] int32 with
        -1 padding, caches)."""
        alive = (rem > 0) & (cur != eos) & (pos + 1 < max_len)
        paged = is_paged(caches)
        emitted = []
        for _ in range(k):
            wm = alive[:, None] if paged else None
            nxt, caches = self.decode_step(params, caches, cur[:, None], pos,
                                           write_mask=wm)
            emitted.append(torch.where(alive, nxt, -1))
            pos = torch.where(alive, pos + 1, pos)
            rem = torch.where(alive, rem - 1, rem)
            alive = alive & (nxt != eos) & (rem > 0) & (pos + 1 < max_len)
            cur = torch.where(alive, nxt, cur)
        return torch.stack(emitted, dim=1), caches

    @property
    def chunkable(self) -> bool:
        """Chunked zero-copy prefill needs position-indexed caches;
        recurrent state (mamba, rwkv) cannot be write-masked."""
        return self.cfg.ssm is None and self.cfg.rwkv is None

    @property
    def pageable(self) -> bool:
        """Paged KV residency needs one uniform, position-indexed KV shape
        per layer and no sliding-window ring."""
        return (self._structure() in ("uniform_attn", "uniform_moe")
                and not self.cfg.sliding_window)

    def prefill_chunk_into(self, params: Params, caches, chunk, start,
                           n_valid):
        """Attend one fixed-shape prompt chunk per admitting row and write
        its KV in place into the pages.

          chunk   [B, C] int32 — per-row prompt slices;
          start   [B] int32 — absolute position of each row's chunk;
          n_valid [B] int32 — real prompt tokens in the row's chunk (0:
                  the row is not admitting; nothing is written for it).

        Returns (next_tok [B] int32 after each row's last valid position,
        caches)."""
        B, C = chunk.shape
        write_mask = (torch.arange(C, device=chunk.device)[None, :]
                      < n_valid[:, None])
        hidden, caches, _ = self.forward(
            params, chunk, caches=caches, cache_pos=start,
            start_pos=start[:, None], write_mask=write_mask)
        last = torch.clamp(n_valid.long() - 1, 0, C - 1)
        last_h = hidden[torch.arange(B, device=chunk.device), last][:, None]
        return self._greedy(params, last_h), caches

    def chunked_block(self, params: Params, caches, chunk, start, n_valid,
                      cur, pos, rem, eos, *, k: int, max_len: int):
        """One fused admission+decode dispatch: the chunk lands first,
        then the decoding rows advance ``k`` steps.  A row whose final
        chunk rides this dispatch (``n_valid > 0`` and ``rem > 0``) joins
        the decode block with its on-device prefill token."""
        next_tok, caches = self.prefill_chunk_into(params, caches, chunk,
                                                   start, n_valid)
        joins = (n_valid > 0) & (rem > 0)
        cur = torch.where(joins, next_tok, cur)
        block, caches = self.decode_loop(params, caches, cur, pos, rem, eos,
                                         k=k, max_len=max_len)
        return next_tok, block, caches


def prefix_chunk_hashes(tokens, chunk_tokens: int):
    """Chained hashes of the chunk-aligned prefixes of a token stream.

    Returns one digest per *full* chunk: ``out[d]`` identifies the
    prefix ``tokens[:(d + 1) * chunk_tokens]``, with each chunk's hash
    folding in its predecessor's so equal digests imply equal whole
    prefixes.  The engine hashes the bucketed, LEFT-PADDED prompt stream,
    so "same digest" is exactly the condition under which two sequences'
    KV pages are interchangeable.  Host-side and model-free: the digest
    keys which prefill dispatches can be skipped.
    """
    toks = np.ascontiguousarray(np.asarray(tokens, np.int32))
    out = []
    h = hashlib.blake2b(str(chunk_tokens).encode(), digest_size=16)
    for d in range(len(toks) // chunk_tokens):
        h = h.copy()
        h.update(toks[d * chunk_tokens:(d + 1) * chunk_tokens].tobytes())
        out.append(int.from_bytes(h.digest(), "little"))
    return out


def build_model(cfg: ModelConfig, remat_policy: str = "nothing",
                device: Union[str, torch.device, None] = None) -> Model:
    """The port's model for ``cfg`` on ``device`` (CUDA by default)."""
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy {remat_policy!r} not in "
                         f"{REMAT_POLICIES}")
    model = Model(cfg, resolve_device(device), remat_policy=remat_policy)
    fam = model._structure()
    if fam not in ("uniform_attn", "uniform_moe", "gemma_local_global"):
        raise NotImplementedError(
            f"{cfg.name}: the {fam} family is not ported yet (ROADMAP, "
            "'Still to port': vlm_cross, enc_dec, zamba_hybrid and "
            "uniform_rwkv)")
    return model
