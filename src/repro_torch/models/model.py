"""Model assembly for every family of the JAX package: uniform attention
(``smollm-135m``), mixture-of-experts (``olmoe-1b-7b``, ``arctic-480b``),
local:global (``gemma3-27b``), cross-attention (``llama-3.2-vision-11b``:
vlm_cross; ``whisper-tiny``: enc_dec) and the recurrent ones
(``zamba2-2.7b``: mamba2 layers around one shared attention block;
``rwkv6-1.6b``: uniform rwkv6 layers).

``build_model(cfg, remat_policy="nothing", device=None)`` returns a
:class:`Model` exposing the JAX package's training and serving surface
over plain parameter dicts of tensors:

  init(generator) -> params
  loss(params, batch) -> (total, {"xent", "aux"})       [training]
  init_cache(batch, max_len, extras_len=0) -> dense ring cache
  fill_cross_cache(params, cache, source) -> cache with cross K/V
  forward(params, tokens, extras=, caches=, cache_pos=, start_pos=,
          write_mask=) -> (hidden, caches, aux)
  prefill(params, tokens, max_len, extras=None)
      -> (next_tok [B], fresh dense cache)
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
``min(W, max_len)`` slots and global rings of ``max_len``; for the
cross-attention families self rings beside static cross K/V of the
source's length, which ``fill_cross_cache`` writes; for the recurrent
families their per-layer state, beside zamba's superblock rings).  Both
are updated in place, so the returned cache is the one passed in.  A
scalar position (prefill, lockstep wave decode) is a Python int; per-row
positions are a [B] tensor.  The layer stack is a Python loop (the JAX
package's ``lax.scan``); without a cache and with gradients on, each
layer runs under the remat policy.  Entry points
run on CUDA unless ``device="cpu"`` is passed; without a card they raise.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import math
import operator
from typing import Any, Dict, Union

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.models import mamba2 as m2
from repro_torch.models import rwkv6 as rw
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (attend_static, attention, cross_kv,
                                       embed, init_kv_cache, is_paged, mlp,
                                       ring_page_size, rms_norm,
                                       unembed_matrix)
from repro_torch.models.losses import chunked_softmax_xent, full_logits
from repro_torch.models.moe import moe_block
from repro_torch.parallel.sharding import Axes, shard

Params = Dict[str, Any]

# A layer slice of more elements than this is drawn by ``Model.init`` one
# slice of its leading axis at a time (arctic-480b's expert leaves,
# [128, 7168, 4864] a layer: 17.8 GB in float32 drawn whole).
DRAW_WHOLE_MAX = 1 << 31


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
               cache=None, cache_pos=None, write_mask=None, kv_source=None):
    """Pre-norm attention (self, or cross over ``kv_source``), then the
    MLP when the block has one."""
    h = rms_norm(p["ln1"], x, cfg.norm_eps)
    a, cache = attention(p["attn"], cfg, h, positions, window=window,
                         cache=cache, cache_pos=cache_pos,
                         write_mask=write_mask, kv_source=kv_source)
    return _mlp_residual(p, cfg, x + a), cache


def _mlp_residual(p: Params, cfg: ModelConfig, x):
    """``x`` plus the MLP of its norm, where the block has an MLP (the
    enc_dec decoder's self block has none)."""
    if "mlp" in p:
        x = x + mlp(p["mlp"], rms_norm(p["ln2"], x, cfg.norm_eps))
    return x


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


def mamba_layer(p: Params, cfg: ModelConfig, x, cache=None):
    """Pre-norm mamba2 mixer (zamba's layers, ``model.py:162-166`` of the
    JAX package): (x, new cache or None)."""
    y, cache = m2.mamba2_block(p["mixer"], cfg,
                               rms_norm(p["ln"], x, cfg.norm_eps), cache)
    return x + y, cache


def rwkv_layer(p: Params, cfg: ModelConfig, x, cache=None):
    """Time-mix, then channel-mix, each pre-norm (``model.py:174-186``
    there): (x, new cache or None)."""
    y, c1 = rw.rwkv6_time_mix(p["rwkv"], cfg,
                              rms_norm(p["ln1"], x, cfg.norm_eps), cache)
    x = x + y
    y, c2 = rw.rwkv6_channel_mix(p["rwkv"], cfg,
                                 rms_norm(p["ln2"], x, cfg.norm_eps), cache)
    return x + y, None if cache is None else {**c1, **c2}


def _block(p: Params, cfg: ModelConfig, x, positions, window=0, cache=None,
           cache_pos=None, write_mask=None, kv_source=None, cross=False):
    """One layer of any family: (x, cache, aux); aux is None but under
    MoE.  ``window`` is the layer's sliding window (0: global).  A
    ``cross`` layer attends over ``kv_source`` without a cache and over
    its static K/V with one.  A recurrent layer's new state is copied
    into its cache in place."""
    if "mixer" in p or "rwkv" in p:
        fn = mamba_layer if "mixer" in p else rwkv_layer
        x, new = fn(p, cfg, x, cache)
        if cache is not None:
            for name, t in new.items():
                cache[name].copy_(t)
        return x, cache, None
    if "moe" in p:
        return moe_layer(p, cfg, x, positions, cache, cache_pos, write_mask)
    if cross and cache is not None:
        h = rms_norm(p["ln1"], x, cfg.norm_eps)
        x = x + attend_static(p["attn"], cfg, h, cache)
        return _mlp_residual(p, cfg, x), cache, None
    x, cache = attn_block(p, cfg, x, positions, window, cache, cache_pos,
                          write_mask, kv_source=kv_source)
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

    def _vlm_plan(self):
        """(superblocks, layers per superblock, index of its cross layer),
        as the JAX package's ``_vlm_plan`` (``model.py:290-294`` there):
        (8, 5, 3) for llama-3.2-vision-11b, whose superblocks run self
        layers 0-2, the cross layer, then self layer 4."""
        per = self.cfg.cross_attn_every
        nsb = self.cfg.num_layers // per
        if nsb * per != self.cfg.num_layers:
            raise ValueError(f"{self.cfg.name}: {self.cfg.num_layers} layers "
                             f"are not superblocks of {per}")
        return nsb, per, per - 2

    def _gemma_plan(self):
        """(local layers per superblock, superblocks, trailing local
        layers), as the JAX package's ``_gemma_plan`` (``model.py:277-282``
        there): (5, 10, 2) for gemma3-27b."""
        per = self.cfg.local_global_ratio
        nsb = self.cfg.num_layers // (per + 1)
        return per, nsb, self.cfg.num_layers - nsb * (per + 1)

    def _zamba_plan(self):
        """(superblocks, mamba layers per superblock), as the JAX
        package's ``_zamba_plan`` (``model.py:284-288`` there): (9, 6) for
        zamba2-2.7b, each superblock the shared attention block, then its
        6 mamba layers."""
        per = self.cfg.attn_every
        nsb = self.cfg.num_layers // per
        if nsb * per != self.cfg.num_layers:
            raise ValueError(f"{self.cfg.name}: {self.cfg.num_layers} layers "
                             f"are not superblocks of {per}")
        return nsb, per

    # -- parameters ----------------------------------------------------------
    def init(self, generator: torch.Generator) -> Params:
        """Random weights with the JAX package's distribution
        (``ParamBuilder``): fan-in-scaled normal for projections, unit
        normal for the embedding, ones for norms, and the recurrent
        layers' own ``scale=`` normals and ``zero=`` leaves.  Drawn in
        float32 on the generator's device, then cast to the compute dtype
        on the model's device: every layer-stacked leaf one layer at a
        time, a layer slice of more than ``DRAW_WHOLE_MAX`` elements one
        slice of its leading axis (an expert) at a time, and an embedding
        table of more than 2^28 entries in pieces of rows, so the float32
        transient is one layer's at most (olmoe's whole expert
        ``wi_gate`` would be 8.6 GB, gemma3-27b's ``wi_gate`` stack 28.7
        GB and its table 5.6 GB) and one expert's for arctic-480b (a
        layer's expert leaf is 17.8 GB).  The numbers differ from
        ``jax.random``'s."""
        cfg = self.cfg
        d, f = cfg.d_model, cfg.d_ff
        nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
        dt = cfg.compute_dtype

        def normal(shape, fan_in, scale=None):
            s = fan_in ** -0.5 if scale is None else scale
            x = torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=generator.device)
            return x.mul_(s).to(device=self.device, dtype=dt)

        def stacked(lead, shape, fan_in=None, scale=None):
            out = torch.empty(lead + shape, dtype=dt, device=self.device)
            whole = math.prod(shape) <= DRAW_WHOLE_MAX
            for one in out.view((-1,) + shape):
                for piece in ([one] if whole else one):
                    piece.copy_(normal(piece.shape, fan_in, scale))
            return out

        def ones(*shape):
            return torch.ones(shape, dtype=dt, device=self.device)

        def zeros(*shape):
            return torch.zeros(shape, dtype=dt, device=self.device)

        def mamba_layers(*lead):
            """``mamba_layer_params`` (``mamba2.py:30-47`` there)."""
            ss, d_in, mh = m2._dims(cfg)
            N, K, xbc = ss.state_dim, ss.conv_kernel, d_in + 2 * ss.state_dim
            return {"ln": ones(*lead, d), "mixer": {
                "in_proj": stacked(lead, (d, 2 * d_in + 2 * N + mh), d),
                "conv_w": stacked(lead, (K, xbc), scale=K ** -0.5),
                "conv_b": zeros(*lead, xbc),
                "a_log": stacked(lead, (mh,), scale=1.0),
                "dt_bias": stacked(lead, (mh,), scale=1.0),
                "d_skip": stacked(lead, (mh,), scale=1.0),
                "norm": stacked(lead, (d_in,), scale=1.0),
                "out_proj": stacked(lead, (d_in, d), d_in)}}

        def rwkv_layers(*lead):
            """``rwkv_layer_params`` (``rwkv6.py:34-63`` there)."""
            rh, rhd = rw._dims(cfg)
            r = cfg.rwkv.decay_lora
            half = {n: stacked(lead, (d,), scale=0.5) for n in (
                "mix_r", "mix_k", "mix_v", "mix_g", "mix_w", "cmix_k",
                "cmix_r")}
            sq = {n: stacked(lead, (d, d), d)
                  for n in ("wr", "wk", "wv", "wg", "wo", "cr")}
            return {"ln1": ones(*lead, d), "ln2": ones(*lead, d), "rwkv": {
                **half, **sq,
                "w0": stacked(lead, (d,), scale=1.0),
                "w_lora_a": stacked(lead, (d, r), d),
                "w_lora_b": stacked(lead, (r, d), r),
                "u_bonus": stacked(lead, (rh, rhd), scale=0.3),
                "ln_x": stacked(lead, (d,), scale=1.0),
                "ck": stacked(lead, (d, f), d),
                "cv": stacked(lead, (f, d), f)}}

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

        def block(*lead):
            return {**attn_layers(*lead), "mlp": dense_mlp(*lead)}

        emb = {"table": table()}
        if not cfg.tie_embeddings:
            emb["unembed"] = normal((d, cfg.vocab_size), d)
        out = {"embed": emb}
        fam = self._structure()
        if fam == "vlm_cross":
            nsb, per, _ = self._vlm_plan()
            out["super"] = {"selfs": block(nsb, per - 1), "cross": block(nsb)}
        elif fam == "enc_dec":
            out["encoder"] = block(cfg.encoder.num_layers)
            out["enc_norm"] = ones(d)
            selfs = attn_layers(cfg.num_layers)
            del selfs["ln2"]                    # no MLP: ``with_mlp=False``
            out["layers"] = {"self": selfs, "cross": block(cfg.num_layers)}
        elif fam == "gemma_local_global":
            per, nsb, tail = self._gemma_plan()
            out["super"] = {"local": block(nsb, per), "global": block(nsb)}
            if tail:
                out["tail"] = block(tail)
        elif fam == "zamba_hybrid":
            nsb, per = self._zamba_plan()
            out["shared_attn"] = block()
            out["super"] = mamba_layers(nsb, per)
        elif fam == "uniform_rwkv":
            out["layers"] = rwkv_layers(cfg.num_layers)
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

    def param_axes(self) -> Params:
        """The logical axes of every leaf of :meth:`init`'s tree, an
        :class:`~repro_torch.parallel.sharding.Axes` per leaf, as the JAX
        package's ``param_axes`` (``model.py:300`` there, through its
        ``ParamBuilder("axes")``); each layer-stacking dimension is
        ``"layers"``."""
        cfg = self.cfg

        def ax(lead, *names):
            return Axes(*(("layers",) * len(lead) + names))

        def attn_layers(*lead):
            attn = {"wq": ax(lead, "embed", "heads", "head_dim"),
                    "wk": ax(lead, "embed", "kv_heads", "head_dim"),
                    "wv": ax(lead, "embed", "kv_heads", "head_dim"),
                    "wo": ax(lead, "heads", "head_dim", "embed")}
            if cfg.qk_norm:
                attn["q_norm"] = ax(lead, "head_dim")
                attn["k_norm"] = ax(lead, "head_dim")
            return {"ln1": ax(lead, "embed"), "attn": attn,
                    "ln2": ax(lead, "embed")}

        def dense_mlp(*lead):
            return {"wi_gate": ax(lead, "embed", "mlp"),
                    "wi_up": ax(lead, "embed", "mlp"),
                    "wo": ax(lead, "mlp", "embed")}

        def block(*lead):
            return {**attn_layers(*lead), "mlp": dense_mlp(*lead)}

        def mamba_layers(*lead):
            return {"ln": ax(lead, "embed"), "mixer": {
                "in_proj": ax(lead, "embed", "mlp"),
                "conv_w": ax(lead, "conv_kernel", "mlp"),
                "conv_b": ax(lead, "mlp"),
                "a_log": ax(lead, "heads"), "dt_bias": ax(lead, "heads"),
                "d_skip": ax(lead, "heads"), "norm": ax(lead, "mlp"),
                "out_proj": ax(lead, "mlp", "embed")}}

        def rwkv_layers(*lead):
            r = {n: ax(lead, "embed") for n in (
                "mix_r", "mix_k", "mix_v", "mix_g", "mix_w", "cmix_k",
                "cmix_r")}
            r.update({n: ax(lead, "embed", "qkv")
                      for n in ("wr", "wk", "wv", "wg", "cr")})
            r.update({"w0": ax(lead, "qkv"), "ln_x": ax(lead, "qkv"),
                      "w_lora_a": ax(lead, "embed", None),
                      "w_lora_b": ax(lead, None, "qkv"),
                      "u_bonus": ax(lead, "heads", "head_dim"),
                      "wo": ax(lead, "qkv", "embed"),
                      "ck": ax(lead, "embed", "mlp"),
                      "cv": ax(lead, "mlp", "embed")})
            return {"ln1": ax(lead, "embed"), "ln2": ax(lead, "embed"),
                    "rwkv": r}

        emb = {"table": Axes("vocab", "embed")}
        if not cfg.tie_embeddings:
            emb["unembed"] = Axes("embed", "vocab")
        out = {"embed": emb}
        fam = self._structure()
        if fam == "vlm_cross":
            nsb, per, _ = self._vlm_plan()
            out["super"] = {"selfs": block(nsb, per - 1), "cross": block(nsb)}
        elif fam == "enc_dec":
            out["encoder"] = block(cfg.encoder.num_layers)
            out["enc_norm"] = Axes("embed")
            selfs = attn_layers(cfg.num_layers)
            del selfs["ln2"]
            out["layers"] = {"self": selfs, "cross": block(cfg.num_layers)}
        elif fam == "gemma_local_global":
            per, nsb, tail = self._gemma_plan()
            out["super"] = {"local": block(nsb, per), "global": block(nsb)}
            if tail:
                out["tail"] = block(tail)
        elif fam == "zamba_hybrid":
            nsb, per = self._zamba_plan()
            out["shared_attn"] = block()
            out["super"] = mamba_layers(nsb, per)
        elif fam == "uniform_rwkv":
            out["layers"] = rwkv_layers(cfg.num_layers)
        else:
            L = (cfg.num_layers,)
            layers = attn_layers(*L)
            if cfg.moe is None:
                layers["mlp"] = dense_mlp(*L)
            else:
                layers["moe"] = {
                    "router": ax(L, "embed", None),
                    "wi_gate": ax(L, "expert", "expert_data", "expert_mlp"),
                    "wi_up": ax(L, "expert", "expert_data", "expert_mlp"),
                    "wo": ax(L, "expert", "expert_mlp", "expert_data")}
                if cfg.moe.dense_residual:
                    layers["dense"] = dense_mlp(*L)
            out["layers"] = layers
        out["final_norm"] = Axes("embed")
        return out

    # -- forward -------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, extras_len: int = 0,
                   device: Union[str, torch.device, None] = None
                   ) -> Dict[str, Any]:
        """Dense ring cache of the whole stack, zeros in the compute
        dtype on ``device`` (the model's by default; "meta" gives the
        shapes alone): ``{"k", "v"}`` of ``[L, batch, size, Hkv, hd]``,
        or the JAX package's tree (``model.py:579-623`` there): for the
        local:global family ``{"super": {"local": [nsb, per, ...],
        "global": [nsb, ...]}, "tail": [tail, ...]}``, local rings of
        ``min(W, max_len)`` slots and global ones of ``max_len``; for the
        cross-attention families the self rings beside static cross K/V
        of ``extras_len`` source positions (the image tokens or encoder
        frames by default), ``{"super": {"selfs": [nsb, per - 1, ...],
        "cross": [nsb, ...]}}`` (vlm_cross) or ``{"self": [L, ...],
        "cross": [L, ...]}`` (enc_dec); for the recurrent families their
        state, ``{"shift_tm", "shift_cm", "wkv"}`` of ``[L, ...]`` (rwkv)
        or ``{"super": {"attn": [nsb, ...], "mamba": {"conv", "ssm"} of
        [nsb, per, ...]}}`` (zamba: a ring per superblock for the shared
        attention block), the state float32."""
        cfg = self.cfg
        dev = self.device if device is None else device
        W = cfg.sliding_window

        def stack(lead, one):
            return {n: a.new_zeros(lead + tuple(a.shape))
                    for n, a in one.items()}

        def rings(lead, window=0, size=max_len):
            return stack(lead, init_kv_cache(cfg, batch, size, window=window,
                                             device=dev))

        fam = self._structure()
        if fam == "uniform_rwkv":
            return stack((cfg.num_layers,),
                         rw.init_rwkv_cache(cfg, batch, device=dev))
        if fam == "zamba_hybrid":
            nsb, per = self._zamba_plan()
            return {"super": {"attn": rings((nsb,)), "mamba": stack(
                (nsb, per), m2.init_mamba_cache(cfg, batch, device=dev))}}
        if fam == "vlm_cross":
            nsb, per, _ = self._vlm_plan()
            src = extras_len or cfg.num_image_tokens
            return {"super": {"selfs": rings((nsb, per - 1), W),
                              "cross": rings((nsb,), size=src)}}
        if fam == "enc_dec":
            src = extras_len or cfg.encoder.num_frames
            return {"self": rings((cfg.num_layers,)),
                    "cross": rings((cfg.num_layers,), size=src)}
        if fam != "gemma_local_global":
            return rings((cfg.num_layers,), W)
        per, nsb, tail = self._gemma_plan()
        out = {"super": {"local": rings((nsb, per), W),
                         "global": rings((nsb,))}}
        if tail:
            out["tail"] = rings((tail,), W)
        return out

    def fill_cross_cache(self, params: Params, caches, source):
        """Write the cross layers' K/V of ``source`` into ``caches`` in
        place and return them (``model.py:625-644`` there): the image
        embeddings [B, n_img, D] (vlm_cross), or the encoder's output of
        the frames [B, n_frames, D] (enc_dec; the encoder runs once).
        Other families' caches come back unchanged."""
        cfg = self.cfg
        fam = self._structure()
        if fam == "enc_dec":
            source = self._encode(params, source)
            lp, c, n = params["layers"]["cross"], caches["cross"], \
                cfg.num_layers
        elif fam == "vlm_cross":
            lp, c, n = (params["super"]["cross"], caches["super"]["cross"],
                        self._vlm_plan()[0])
        else:
            return caches
        for i in range(n):
            kv = cross_kv(_layer(lp["attn"], i), cfg, source)
            for name in ("k", "v"):
                c[name][i].copy_(kv[name])
        return caches

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
        window, cross): the local:global family runs each superblock's
        ``per`` windowed layers, then its global layer with window 0, then
        the windowed tail (``model.py:393-432`` there); vlm_cross each
        superblock's self layers with its cross layer at ``cross_at``
        (``:457-492``); enc_dec each decoder layer's self block, then its
        cross block (``:494-513``); zamba each superblock's shared
        attention block over the superblock's own ring, then its mamba
        layers (``:433-455``).  The shared block's parameters
        (``("shared_attn",)``) carry no layer index."""
        cfg = self.cfg
        fam = self._structure()
        if fam == "zamba_hybrid":
            nsb, per = self._zamba_plan()
            order = []
            for s in range(nsb):
                order.append((("shared_attn",), ("super", "attn"), (s,), 0,
                              False))
                order += [(("super",), ("super", "mamba"), (s, i), 0, False)
                          for i in range(per)]
            return order
        if fam == "vlm_cross":
            nsb, per, cross_at = self._vlm_plan()
            selfs, cross = ("super", "selfs"), ("super", "cross")
            order = []
            for s in range(nsb):
                order += [(selfs, selfs, (s, i), 0, False)
                          for i in range(cross_at)]
                order.append((cross, cross, (s,), 0, True))
                order += [(selfs, selfs, (s, i), 0, False)
                          for i in range(cross_at, per - 1)]
            return order
        if fam == "enc_dec":
            order = []
            for li in range(cfg.num_layers):
                order += [(("layers", "self"), ("self",), (li,), 0, False),
                          (("layers", "cross"), ("cross",), (li,), 0, True)]
            return order
        if fam != "gemma_local_global":
            return [(("layers",), (), (li,), cfg.sliding_window, False)
                    for li in range(cfg.num_layers)]
        per, nsb, tail = self._gemma_plan()
        W, local, glob = cfg.sliding_window, ("super", "local"), (
            "super", "global")
        order = []
        for s in range(nsb):
            order += [(local, local, (s, i), W, False) for i in range(per)]
            order.append((glob, glob, (s,), 0, False))
        return order + [(("tail",), ("tail",), (i,), W, False)
                        for i in range(tail)]

    def _stack(self, params: Params, caches):
        """(layer params, its cache or None, its window, cross) for each
        layer in order: a self layer's dense ring comes with its identity
        block table, a cross layer's static K/V and a recurrent layer's
        state with none (the paged view never sees either)."""
        for ppath, cpath, idx, window, cross in self._order():
            c = None
            if caches is not None:
                c = _layer(functools.reduce(operator.getitem, cpath,
                                            caches), *idx)
                if "k" in c and not cross:
                    c["block"] = self._ring_block(*c["k"].shape[:2])
            lp = functools.reduce(operator.getitem, ppath, params)
            yield (lp if ppath == ("shared_attn",) else _layer(lp, *idx), c,
                   window, cross)

    def _remat(self, fn, *args):
        """``fn(*args)`` under the remat policy when gradients are on."""
        pol = self.remat_policy
        if pol == "none" or not torch.is_grad_enabled():
            return fn(*args)
        if pol == "dots":
            ctx = functools.partial(create_selective_checkpoint_contexts,
                                    _dots_policy)
            return checkpoint(fn, *args, use_reentrant=False,
                              context_fn=ctx)
        return checkpoint(fn, *args, use_reentrant=False)

    def _remat_block(self, lp: Params, x, positions, window: int,
                     kv_source=None, cross: bool = False):
        """One cache-less layer under the remat policy: (x, aux or
        None)."""
        def block(lp, x, positions, kv_source):
            x, _, aux = _block(lp, self.cfg, x, positions, window,
                               kv_source=kv_source, cross=cross)
            return x, aux

        return self._remat(block, lp, x, positions, kv_source)

    def _encode(self, params: Params, frame_embeds):
        """The whisper encoder (``model.py:519-534`` there): bidirectional
        self-attention over the frames (``kv_source`` is the layer's own
        normed input), each layer under the remat policy, then
        ``enc_norm``."""
        cfg = self.cfg
        if frame_embeds is None:
            raise ValueError(f"{cfg.name}: the encoder needs frame "
                             "embeddings [B, n_frames, d_model]")
        B, S, _ = frame_embeds.shape
        positions = torch.arange(S, device=frame_embeds.device).expand(B, S)

        def body(lp, x):
            h = rms_norm(lp["ln1"], x, cfg.norm_eps)
            a, _ = attention(lp["attn"], cfg, h, positions, kv_source=h)
            x = x + a
            return x + mlp(lp["mlp"], rms_norm(lp["ln2"], x, cfg.norm_eps))

        x = frame_embeds.to(cfg.compute_dtype)
        for li in range(cfg.encoder.num_layers):
            x = self._remat(body, _layer(params["encoder"], li), x)
        return rms_norm(params["enc_norm"], x, cfg.norm_eps)

    def _run_stack(self, params: Params, x, positions, caches, cache_pos,
                   write_mask=None, extras=None):
        """-> (hidden, caches, aux): aux sums the layers' load-balance
        losses (0 but under MoE).  ``extras`` is what a cache-less cross
        layer attends over (image embeddings, the encoder's output); with
        a cache it reads its static K/V instead."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if self._structure() == "zamba_hybrid":
            # The shared block is called without a write mask
            # (``model.py:437-440`` there); the family is not chunkable, so
            # no dispatch of the engine passes one.
            write_mask = None
        if caches is not None and is_paged(caches):
            for li in range(self.cfg.num_layers):
                x, _, a = _block(_layer(params["layers"], li), self.cfg, x,
                                 positions, cache={**caches, "layer": li},
                                 cache_pos=cache_pos, write_mask=write_mask)
                if a is not None:
                    aux = aux + a
            return x, caches, aux
        for lp, c, window, cross in self._stack(params, caches):
            if c is None:
                x, a = self._remat_block(lp, x, positions, window,
                                         extras if cross else None, cross)
            else:
                x, _, a = _block(lp, self.cfg, x, positions, window, cache=c,
                                 cache_pos=cache_pos, write_mask=write_mask,
                                 cross=cross)
            if a is not None:
                aux = aux + a
        return x, caches, aux

    def forward(self, params: Params, tokens: torch.Tensor, extras=None,
                caches=None, cache_pos=None, start_pos=None,
                write_mask=None):
        """tokens [B, T] -> (final hidden [B, T, D], caches, aux).
        ``extras``: image embeddings (vlm_cross) or audio frame
        embeddings, which the encoder runs over first (enc_dec), for the
        cache-less cross layers; without them such a layer attends over
        its own input, as in the JAX package."""
        cfg = self.cfg
        tokens = shard(tokens, "batch", "seq")
        B, T = tokens.shape
        ar = torch.arange(T, device=tokens.device)
        if start_pos is None:
            positions = ar.expand(B, T)
        else:
            positions = torch.broadcast_to(start_pos + ar, (B, T))
        x = embed(params["embed"], tokens, cfg)
        if cfg.encoder is not None and extras is not None:
            extras = self._encode(params, extras)
        x, caches, aux = self._run_stack(params, x, positions, caches,
                                         cache_pos, write_mask=write_mask,
                                         extras=extras)
        return rms_norm(params["final_norm"], x, cfg.norm_eps), caches, aux

    def loss(self, params: Params, batch: Dict[str, torch.Tensor]):
        """batch {"tokens": [B, T]} (+ "image_embeds" / "frame_embeds")
        -> (total, {"xent", "aux"}).

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
        extras = batch.get("image_embeds", batch.get("frame_embeds"))
        hidden, _, aux = self.forward(params, tokens, extras=extras)
        w_out = unembed_matrix(params["embed"], cfg).to(cfg.compute_dtype)
        # The labels rolled left one position (``torch.roll``, spelled
        # as a concatenation, which DTensor shards on every version).
        labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
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

    def prefill(self, params: Params, tokens: torch.Tensor, max_len: int,
                extras=None):
        """Process whole prompts [B, T] into a fresh dense ring cache of
        ``max_len`` positions; returns (greedy next token [B], cache).
        Attention is the flash kernel's causal prefill on CUDA.  The
        cross caches are filled first from ``extras`` [B, S, D] when
        given (their length S), and always for enc_dec, whose encoder
        needs its frames (``model.py:819-833`` there); otherwise they stay
        zeros, over which cross-attention gives 0."""
        n_src = 0 if extras is None else extras.shape[1]
        caches = self.init_cache(tokens.shape[0], max_len, extras_len=n_src)
        if extras is not None or self.cfg.encoder is not None:
            self.fill_cross_cache(params, caches, extras)
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
        caches).  A recurrent family raises, as in the JAX package: its
        state folds every token in and cannot be write-masked."""
        if not self.chunkable:
            raise NotImplementedError(
                f"{self.cfg.name}: chunked prefill needs position-indexed "
                "caches; recurrent state cannot be write-masked")
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
    return Model(cfg, resolve_device(device), remat_policy=remat_policy)
