"""Non-Blocking Write (NBW) protocol — lock-free *state* messaging.

Kopetz & Reisinger's NBW protocol (RTSS 1993) as summarized in Section 3 of
the paper: a single atomic version counter guards an array of buffers.

  writer:  c += 1 ; write buffer[(c//2) mod K] ; c += 1
  reader:  c0 = c ; (retry if odd) ; read buffer ; c1 = c ;
           success iff c1 == c0, else retry (bounded).

State messages are *indeterminate order* — the reader always wants the most
recent value.  The writer is never blocked by readers (the paper's
Non-blocking property); readers detect collisions optimistically (Safety)
and their retry count is bounded by buffer depth (Timeliness).

Framework uses:
  * publishing parameter snapshots from the training loop to the async
    checkpointer without stalling the step,
  * publishing fresh weights to a serving engine (weight hot-swap),
  * scalar telemetry (step counter, loss) between host actors.

Two variants: :class:`HostNBW` for host threads, and the functional
device cell (:class:`NBWState`, :func:`init`, :func:`write`, :func:`read`,
``core/nbw.py:86-110`` of the JAX package) on tensors, which never reads
its counter on the host.
"""
from __future__ import annotations

import copy
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

# Status codes for the explicit (non-retrying) reader.
OK = 0
READ_COLLISION = 1   # writer overwrote the slot mid-read; try again
WRITE_IN_PROGRESS = 2


class HostNBW:
    """Host-side NBW slot: one writer thread, any number of reader threads.

    The version counter is a plain int (atomic store/load under CPython).
    ``depth`` > 1 makes collisions rarer, exactly as the paper notes: "the
    more array buffers there are, the less likely a collision".
    """

    __slots__ = ("_depth", "_bufs", "_version", "_copy")

    def __init__(self, depth: int = 2, deepcopy: bool = False):
        if depth < 1:
            raise ValueError("NBW depth must be >= 1")
        self._depth = depth
        self._bufs: list = [None] * depth
        self._version = 0
        self._copy: Callable[[Any], Any] = (
            copy.deepcopy if deepcopy else (lambda x: x))

    @property
    def version(self) -> int:
        return self._version // 2

    def write(self, value: Any) -> None:
        """Publish a new value.  Never blocks, regardless of readers."""
        v = self._version
        self._version = v + 1                       # odd: write in progress
        self._bufs[((v // 2) + 1) % self._depth] = self._copy(value)
        self._version = v + 2                       # commit new version

    def try_read(self) -> Tuple[int, Optional[Any]]:
        """One optimistic read attempt (explicit status, no spinning)."""
        v0 = self._version
        if v0 & 1:
            return WRITE_IN_PROGRESS, None
        value = self._bufs[(v0 // 2) % self._depth]
        if self._version != v0:
            return READ_COLLISION, None
        return OK, value

    def read(self, max_retries: int = 1 << 16) -> Any:
        """Spin (lock-free, bounded) until an uncorrupted read succeeds."""
        for _ in range(max_retries):
            status, value = self.try_read()
            if status == OK:
                return value
        raise TimeoutError("NBW read retries exhausted (writer storm)")


# ---------------------------------------------------------------------------
# Functional device variant: a versioned state cell.
# ---------------------------------------------------------------------------
class NBWState(NamedTuple):
    version: torch.Tensor  # int32 scalar, even = stable
    bufs: torch.Tensor     # [depth, *item_shape]


def init(depth: int, item: torch.Tensor) -> NBWState:
    return NBWState(
        torch.zeros((), dtype=torch.int32, device=item.device),
        torch.zeros((depth,) + tuple(item.shape), dtype=item.dtype,
                    device=item.device))


def write(state: NBWState, value: torch.Tensor) -> NBWState:
    depth = state.bufs.shape[0]
    v = state.version
    idx = ((v // 2 + 1) % depth).reshape(1).long()
    return NBWState(v + 2, state.bufs.index_copy(
        0, idx, value.to(state.bufs.dtype)[None]))


def read(state: NBWState) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (value, version).  The functional form cannot collide; the
    collision semantics live in the host variant."""
    depth = state.bufs.shape[0]
    idx = ((state.version // 2) % depth).reshape(1).long()
    return torch.index_select(state.bufs, 0, idx)[0], state.version // 2
