"""Public entry points of the port's kernels.

Each entry dispatches on where its tensors lie: a CPU tensor runs the
kernel's plain PyTorch version, a CUDA tensor launches the hand-written
Hopper kernel or raises.  This replaces the JAX package's ``interpret``
auto-detection (``src/repro/kernels/ops.py:18-21``).
"""
from __future__ import annotations

from repro_torch.kernels import build, ref
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import nbb_matmul as _nbb
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_fwd,
                                                 flash_attention_trainable)
from repro_torch.kernels.nbb_matmul import nbb_matmul
from repro_torch.kernels.paged_attention import paged_attention

__all__ = ["flash_attention", "flash_attention_bwd", "flash_attention_fwd",
           "flash_attention_trainable", "nbb_matmul", "paged_attention", "ref",
           "shared_memory"]


def shared_memory() -> dict:
    """{library: (its instances' ``(name, static bytes, dynamic bytes)``
    as built, {name: the dynamic bytes its wrapper computes from its tile
    constants})} of the four kernel libraries, each built and loaded on
    first use (where ``nvcc`` and a card are)."""
    libs = {"paged_attention": (_pa.SOURCE, _pa._declare,
                                _pa.smem_requests()),
            "flash_attention": (_fa.SOURCE, _fa._declare,
                                _fa.smem_requests()),
            "flash_attention_bwd": (_fa.BWD_SOURCE, _fa._declare_bwd,
                                    _fa.smem_requests(backward=True)),
            "nbb_matmul": (_nbb.SOURCE, _nbb._declare,
                           _nbb.smem_requests())}
    return {name: (build.smem_report(build.load(src, declare), name), want)
            for name, (src, declare, want) in libs.items()}
