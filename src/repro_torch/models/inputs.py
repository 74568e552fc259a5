"""Shapes and dtypes of every model input, and random ones to fill them.

The torch counterpart of the JAX package's ``models/inputs.py``: a spec
is a tensor on the ``meta`` device (shape and dtype, nothing allocated),
the stand-in for ``jax.ShapeDtypeStruct``; :func:`concrete` materializes
a spec tree with random data from a ``torch.Generator``.  Modality
frontends are stubs, as there: a vlm cell gets precomputed patch
embeddings, a whisper cell precomputed audio-frame embeddings.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch

from repro_torch.models.config import ModelConfig, ShapeConfig


def _spec(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _extras_spec(cfg: ModelConfig, B: int) -> Optional[torch.Tensor]:
    """[B, n_src, d_model] in the compute dtype: image embeddings (vlm)
    or encoder frames; None for a family without a source."""
    if cfg.encoder is not None:
        n = cfg.encoder.num_frames
    elif cfg.family == "vlm":
        n = cfg.num_image_tokens
    else:
        return None
    return _spec((B, n, cfg.d_model), cfg.compute_dtype)


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig
                      ) -> Dict[str, torch.Tensor]:
    """{"tokens": [B, S + 1] int32} plus "image_embeds" (vlm) or
    "frame_embeds" (encoder)."""
    B, S = shape.global_batch, shape.seq_len
    specs = {"tokens": _spec((B, S + 1), torch.int32)}
    extras = _extras_spec(cfg, B)
    if extras is not None:
        key = "frame_embeds" if cfg.encoder is not None else "image_embeds"
        specs[key] = extras
    return specs


def prefill_specs(cfg: ModelConfig, shape: ShapeConfig
                  ) -> Dict[str, torch.Tensor]:
    """{"tokens": [B, S] int32} plus "extras", the source of the cross
    layers, for the families that have one."""
    B, S = shape.global_batch, shape.seq_len
    specs = {"tokens": _spec((B, S), torch.int32)}
    extras = _extras_spec(cfg, B)
    if extras is not None:
        specs["extras"] = extras
    return specs


def decode_specs(cfg: ModelConfig, shape: ShapeConfig, model
                 ) -> Dict[str, Any]:
    """Inputs of one decode step: a [B, 1] token, a [B] position and the
    cache of ``seq_len`` positions (``init_cache`` on the meta device:
    rings in the compute dtype and, for the recurrent families, their
    conv or token-shift state beside the float32 recurrent state)."""
    B, S = shape.global_batch, shape.seq_len
    return {"caches": model.init_cache(B, S, device="meta"),
            "tokens": _spec((B, 1), torch.int32),
            "pos": _spec((B,), torch.int32)}


def concrete(specs: Any, generator: Optional[torch.Generator] = None,
             vocab: int = 256,
             device: Union[str, torch.device, None] = None) -> Any:
    """Materialize a spec tree on ``device`` (the generator's by
    default): tokens uniform in ``[0, vocab)``, floating leaves standard
    normal, drawn in float32 and cast to the spec's dtype."""
    g = generator if generator is not None else \
        torch.Generator().manual_seed(0)
    dev = g.device if device is None else torch.device(device)

    def fill(spec):
        if isinstance(spec, dict):
            return {k: fill(v) for k, v in spec.items()}
        if spec.dtype.is_floating_point:
            x = torch.randn(tuple(spec.shape), generator=g,
                            dtype=torch.float32, device=g.device)
            return x.to(device=dev, dtype=spec.dtype)
        x = torch.randint(0, vocab, tuple(spec.shape), generator=g,
                          device=g.device)
        return x.to(device=dev, dtype=spec.dtype)

    return fill(specs)
