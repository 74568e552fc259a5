"""Decode-path logits.  The chunked cross-entropy of the JAX package
(``chunked_softmax_xent``) waits for the training port."""
from __future__ import annotations

import torch


def full_logits(hidden: torch.Tensor, w_out: torch.Tensor) -> torch.Tensor:
    """Decode-path logits (tiny T): [B, T, D] -> [B, T, V], accumulated
    and returned in float32 like the JAX package's
    ``preferred_element_type=float32`` einsum."""
    return torch.einsum("btd,dv->btv", hidden.float(), w_out.float())
