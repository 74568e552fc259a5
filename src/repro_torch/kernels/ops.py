"""Public entry points of the port's kernels.

Each entry dispatches on where its tensors lie: a CPU tensor runs the
kernel's plain PyTorch version, a CUDA tensor launches the hand-written
Hopper kernel or raises.  This replaces the JAX package's ``interpret``
auto-detection (``src/repro/kernels/ops.py:18-21``).
"""
from __future__ import annotations

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_fwd,
                                                 flash_attention_trainable)
from repro_torch.kernels.nbb_matmul import nbb_matmul
from repro_torch.kernels.paged_attention import paged_attention

__all__ = ["flash_attention", "flash_attention_bwd", "flash_attention_fwd",
           "flash_attention_trainable", "nbb_matmul", "paged_attention", "ref"]
