"""Model assembly for the uniform-attention family (``smollm-135m``).

``build_model(cfg, device=None)`` returns a :class:`Model` exposing the
JAX package's serving surface over plain parameter dicts of tensors:

  init(generator) -> params
  forward(params, tokens, caches=, cache_pos=, start_pos=, write_mask=)
  decode_step(params, cache, tokens, pos) -> (next_tok, cache)
  decode_loop(params, cache, cur, pos, rem, eos, k=, max_len=)
      -> (token block [B, k], cache)        [fused packet-mode decode]
  prefill_chunk_into(params, cache, chunk, start, n_valid)
      -> (next_tok [B], cache)     [chunked zero-copy in-place admission]
  chunked_block(...same..., cur, pos, rem, eos, k=, max_len=)
      -> (next_tok, block, cache)  [one dispatch: chunk + K decode steps]

Caches are paged (``layers.is_paged``): the pool's page arrays are
updated in place, so the returned cache is the one passed in.  The layer
stack is a Python loop (the JAX package's ``lax.scan``).  Entry points
run on CUDA unless ``device="cpu"`` is passed; without a card they raise.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Dict, Union

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (attention, embed, is_paged, mlp,
                                       rms_norm, unembed_matrix)
from repro_torch.models.losses import full_logits

Params = Dict[str, Any]


def resolve_device(device: Union[str, torch.device, None]) -> torch.device:
    """The port's device rule: CUDA unless the caller asks for another
    device; no silent fallback to the CPU when no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' "
                           "to run on the CPU")
    return dev


def _layer(tree: Any, li: int) -> Any:
    """Layer ``li``'s slice of a layer-stacked parameter subtree."""
    if isinstance(tree, dict):
        return {k: _layer(v, li) for k, v in tree.items()}
    return tree[li]


def attn_block(p: Params, cfg: ModelConfig, x, positions, cache=None,
               cache_pos=None, write_mask=None):
    h = rms_norm(p["ln1"], x, cfg.norm_eps)
    a, cache = attention(p["attn"], cfg, h, positions, cache=cache,
                         cache_pos=cache_pos, write_mask=write_mask)
    x = x + a
    x = x + mlp(p["mlp"], rms_norm(p["ln2"], x, cfg.norm_eps))
    return x, cache


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    device: torch.device

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

    # -- parameters ----------------------------------------------------------
    def init(self, generator: torch.Generator) -> Params:
        """Random weights with the JAX package's distribution
        (``ParamBuilder``): fan-in-scaled normal for projections, unit
        normal for the embedding, ones for norms.  Drawn in float32 on the
        generator's device, then cast to the compute dtype on the model's
        device.  The numbers differ from ``jax.random``'s."""
        cfg = self.cfg
        d, L, f = cfg.d_model, cfg.num_layers, cfg.d_ff
        nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
        dt = cfg.compute_dtype

        def normal(shape, fan_in, scale=None):
            s = fan_in ** -0.5 if scale is None else scale
            x = torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=generator.device) * s
            return x.to(device=self.device, dtype=dt)

        def ones(*shape):
            return torch.ones(shape, dtype=dt, device=self.device)

        attn = {"wq": normal((L, d, nh, hd), d),
                "wk": normal((L, d, nkv, hd), d),
                "wv": normal((L, d, nkv, hd), d),
                "wo": normal((L, nh, hd, d), nh * hd)}
        if cfg.qk_norm:
            attn["q_norm"] = ones(L, hd)
            attn["k_norm"] = ones(L, hd)
        emb = {"table": normal((cfg.vocab_size, d), 1, scale=1.0)}
        if not cfg.tie_embeddings:
            emb["unembed"] = normal((d, cfg.vocab_size), d)
        return {
            "embed": emb,
            "layers": {
                "ln1": ones(L, d),
                "attn": attn,
                "ln2": ones(L, d),
                "mlp": {"wi_gate": normal((L, d, f), d),
                        "wi_up": normal((L, d, f), d),
                        "wo": normal((L, f, d), f)},
            },
            "final_norm": ones(d),
        }

    # -- forward -------------------------------------------------------------
    def _run_stack(self, params: Params, x, positions, caches, cache_pos,
                   write_mask=None):
        if caches is not None and not is_paged(caches):
            raise NotImplementedError(
                "dense ring KV caches are not ported yet; use a paged cache")
        layers = params["layers"]
        for li in range(self.cfg.num_layers):
            c = None if caches is None else {**caches, "layer": li}
            x, _ = attn_block(_layer(layers, li), self.cfg, x, positions,
                              cache=c, cache_pos=cache_pos,
                              write_mask=write_mask)
        return x, caches

    def forward(self, params: Params, tokens: torch.Tensor, caches=None,
                cache_pos=None, start_pos=None, write_mask=None):
        """tokens [B, T] -> (final hidden [B, T, D], caches)."""
        cfg = self.cfg
        B, T = tokens.shape
        ar = torch.arange(T, device=tokens.device)
        if start_pos is None:
            positions = ar.expand(B, T)
        else:
            positions = torch.broadcast_to(start_pos + ar, (B, T))
        x = embed(params["embed"], tokens, cfg)
        x, caches = self._run_stack(params, x, positions, caches, cache_pos,
                                    write_mask=write_mask)
        return rms_norm(params["final_norm"], x, cfg.norm_eps), caches

    def _greedy(self, params: Params, hidden: torch.Tensor) -> torch.Tensor:
        """hidden [B, 1, D] -> greedy next token [B] int32."""
        w_out = unembed_matrix(params["embed"], self.cfg).to(
            self.cfg.compute_dtype)
        logits = full_logits(hidden, w_out)
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)

    # -- serving -------------------------------------------------------------
    def decode_step(self, params: Params, caches, tokens: torch.Tensor,
                    pos: torch.Tensor, write_mask=None):
        """tokens: [B, 1]; pos: [B] absolute position of each row (the
        paged backend needs per-row positions).  ``write_mask`` [B, 1]
        gates the cache write per row.  Greedy."""
        hidden, caches = self.forward(
            params, tokens, caches=caches, cache_pos=pos,
            start_pos=pos[:, None], write_mask=write_mask)
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
        hidden, caches = self.forward(
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


def build_model(cfg: ModelConfig,
                device: Union[str, torch.device, None] = None) -> Model:
    """The port's model for ``cfg`` on ``device`` (CUDA by default)."""
    model = Model(cfg, resolve_device(device))
    fam = model._structure()
    if fam != "uniform_attn":
        raise NotImplementedError(
            f"{cfg.name}: the {fam} family is not ported yet (ROADMAP, "
            "'Still to port': the other model families)")
    return model
