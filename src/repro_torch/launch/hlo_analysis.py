"""Per-device accounting of FLOPs, bytes and collective traffic
(``src/repro/launch/hlo_analysis.py``).

The JAX module parses a compiled program's HLO text.  PyTorch runs
eagerly, so the port counts the program as it is dispatched: an
:class:`Accountant` is a dispatch mode that sits *below* DTensor (it
declines DTensor operands, so DTensor runs first and hands it the local
shards), and so sees exactly the operations and collectives one device
runs, at their local shapes.  A loop's trip count is exact: every
iteration dispatches.  Under ``FakeTensorMode`` nothing is computed, which
is how the dry-run plans a 256-rank step on one CPU.

Accounting rules (per device):
  * flops       — matrix products, convolutions and fused attention, by
                  ``torch.utils.flop_counter``'s formulas (the JAX module
                  counts dot and convolution ops).
  * bytes       — operands plus results of every operation that touches
                  memory (views and aliases are free): eager PyTorch
                  writes each result to memory.  ``bytes_min`` counts
                  elementwise operations by their result alone, the
                  perfect-fusion floor.
  * collectives — result bytes per operation, by the JAX module's five
                  kinds; a point-to-point receive is a collective-permute.
  * memory      — live bytes of the results still referenced, and their
                  peak (``track_memory=True``).
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils.flop_counter import flop_registry

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")

# Collective operations by (namespace, name) -> kind.  The functional
# collectives return their result; the in-place c10d ones write their
# first argument.
_FUNCTIONAL = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_INPLACE = {
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "_allgather_base_": "all-gather",
    "allgather_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
    "recv_": "collective-permute",
    "recv_any_source_": "collective-permute",
}


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


@dataclasses.dataclass
class Account:
    flops: float = 0.0
    bytes: float = 0.0       # every operation's operands and results
    bytes_min: float = 0.0   # elementwise operations by their result only
    collective_bytes: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVE_KINDS})
    collective_counts: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVE_KINDS})


@dataclasses.dataclass
class Op:
    """One dispatched operation: its name, result bytes and FLOPs."""
    kind: str
    result_bytes: int
    flops: float


def _collective_kind(func) -> Optional[Tuple[str, bool]]:
    """(kind, in place) of a collective operation, else None."""
    ns, name = func.namespace, func._schema.name.split("::")[-1]
    if ns in ("_c10d_functional", "_c10d_functional_autograd") \
            and name in _FUNCTIONAL:
        return _FUNCTIONAL[name], False
    if ns == "c10d" and name in _INPLACE:
        return _INPLACE[name], True
    return None


def _aliases(func) -> bool:
    """Whether the operation's results alias its inputs (views and
    in-place writes allocate nothing)."""
    return any(r.alias_info is not None for r in func._schema.returns)


_FREE_NAMES = {"detach", "alias", "lift_fresh", "_wrap_tensor_autograd",
               "wait_tensor"}


class Accountant(TorchDispatchMode):
    """Counts what one device runs while active (see the module
    docstring).  ``record=True`` keeps an :class:`Op` per operation;
    ``track_memory=True`` follows live result bytes and their peak."""

    def __init__(self, record: bool = False, track_memory: bool = False):
        super().__init__()
        self.account = Account()
        self.ops: Optional[List[Op]] = [] if record else None
        self.track_memory = track_memory
        self.live_bytes = 0
        self.peak_bytes = 0

    def _release(self, n: int) -> None:
        self.live_bytes -= n

    def __enter__(self):
        # The fake-tensor modes active now are the caller's (the
        # dry-run's); one that appears later is DTensor's sharding
        # propagation running an op on fake inputs to learn its output's
        # shape, which no device runs.
        self._own_fakes = {id(m) for m in _get_current_dispatch_mode_stack()
                           if isinstance(m, FakeTensorMode)}
        return super().__enter__()

    def _propagating(self) -> bool:
        return any(isinstance(m, FakeTensorMode)
                   and id(m) not in self._own_fakes
                   for m in _get_current_dispatch_mode_stack())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented        # let DTensor hand us local shards
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._propagating():
            return out
        acc = self.account
        name = func._schema.name.split("::")[-1]
        coll = _collective_kind(func)
        flops = 0.0
        if coll is not None:
            kind, inplace = coll
            b = _nbytes(_tensors(args[0] if inplace else out))
            acc.collective_bytes[kind] += b
            acc.collective_counts[kind] += 1
            acc.bytes += b
            acc.bytes_min += b
        elif func.overloadpacket in flop_registry:
            flops = float(flop_registry[func.overloadpacket](
                *args, **kwargs, out_val=out))
            acc.flops += flops
        if coll is None and not func.is_view and name not in _FREE_NAMES:
            outs = _nbytes(_tensors(out))
            ins = _nbytes(_tensors(args)) + _nbytes(_tensors(kwargs))
            acc.bytes += ins + outs
            pointwise = torch.Tag.pointwise in func.tags
            acc.bytes_min += outs if pointwise else ins + outs
        if self.track_memory and not _aliases(func) \
                and name not in _FREE_NAMES:
            for t in _tensors(out):
                n = t.numel() * t.element_size()
                self.live_bytes += n
                weakref.finalize(t, self._release, n)
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        if self.ops is not None:
            self.ops.append(Op(str(func), _nbytes(_tensors(out)), flops))
        return out


def analyze(fn: Callable, *args, **kwargs) -> Account:
    """The per-device :class:`Account` of one call ``fn(*args,
    **kwargs)``."""
    with Accountant() as a:
        fn(*args, **kwargs)
    return a.account


def trace(fn: Callable, *args, **kwargs
          ) -> Tuple[Dict[str, List[Op]], str]:
    """(operations by program, entry): the operations one call dispatches,
    under the entry's name (the counterpart of ``parse_hlo``'s
    computations and ENTRY)."""
    entry = getattr(fn, "__qualname__", None) or repr(fn)
    with Accountant(record=True) as a:
        fn(*args, **kwargs)
    return {entry: a.ops}, entry
