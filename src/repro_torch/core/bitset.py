"""Lock-free bit set — request/slot allocation without a linked list.

Refactoring step (3) of the paper: the lock-free *doubly linked list* used to
track asynchronous request objects was replaced by a lock-free *bit set*,
because lock-free doubly-linked lists are not feasible in practice
([25][26] in the paper).  A bit set supports the only two operations the
request pool needs — claim-any-free-slot and release-slot — with single-word
atomics.

Host variant: CPython's ``dict.setdefault`` is an atomic compare-and-swap
(single bytecode under the GIL), which gives a genuine lock-free test-and-set
per slot.  Used for KV-cache page allocation and in-flight request tracking
in the serving engine.

Functional variant: claim/release over a packed word tensor (32 slots a
word), for allocator state kept on the device.  torch has no shifts of
uint32, so each word is an int64 holding 32 lanes in its low bits.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import interleave as _il


class HostBitset:
    """Lock-free slot allocator for host threads (multi-producer safe)."""

    __slots__ = ("_n", "_claims")

    def __init__(self, nslots: int):
        self._n = nslots
        # slot -> owner token.  dict.setdefault is our CAS primitive.
        self._claims: dict = {}

    @property
    def capacity(self) -> int:
        return self._n

    def try_claim(self, owner: object = True, start: int = 0) -> Optional[int]:
        """Claim any free slot; returns its index or None when all taken.

        Lock-free: each probe is one atomic setdefault; a failed probe means
        another thread won that slot and we move on (the paper's "progress in
        finite time" guarantee — someone always succeeds).
        """
        n = self._n
        for off in range(n):
            i = (start + off) % n
            if _il._active is not None:
                _il._active.yield_point("bitset.probe", (id(self), i))
            if self._claims.setdefault(i, owner) is owner:
                return i
        return None

    def claim_specific(self, i: int, owner: object = True) -> bool:
        if _il._active is not None:
            _il._active.yield_point("bitset.probe", (id(self), i))
        return self._claims.setdefault(i, owner) is owner

    def release(self, i: int) -> None:
        if _il._active is not None:
            _il._active.yield_point("bitset.release", (id(self), i))
        # pop() is atomic; releasing an unclaimed slot is a programming error.
        if self._claims.pop(i, _MISSING) is _MISSING:
            raise KeyError(f"slot {i} was not claimed")

    def is_claimed(self, i: int) -> bool:
        return i in self._claims

    def count(self) -> int:
        return len(self._claims)


_MISSING = object()


# ---------------------------------------------------------------------------
# Functional variant: words of 32 slots each (int64 words, low 32 bits).
# ---------------------------------------------------------------------------
_LANES = 32


def _lanes(device) -> torch.Tensor:
    return torch.arange(_LANES, dtype=torch.int64, device=device)


def init(nslots: int, device=None) -> torch.Tensor:
    nwords = (nslots + _LANES - 1) // _LANES
    return torch.zeros((nwords,), dtype=torch.int64, device=device)


def _bits(bits: torch.Tensor) -> torch.Tensor:
    """[w, 32] 0/1 lanes of each word."""
    return (bits[:, None] >> _lanes(bits.device)[None, :]) & 1


def claim_first_free(bits: torch.Tensor, nslots: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Claim the lowest free slot.  Returns (new_bits, slot) with slot == -1
    when the set is full (caller branches on it, never blocks).  Computed
    on the bits' device: nothing is read back."""
    nwords = bits.shape[0]
    free = _bits(bits) == 0                                      # [w, 32]
    idx = torch.arange(nwords * _LANES,
                       device=bits.device).view(nwords, _LANES)
    flat = (free & (idx < nslots)).reshape(-1)
    any_free = flat.any()
    slot = torch.where(any_free, torch.argmax(flat.to(torch.uint8)), -1)
    word = torch.clamp(slot, min=0) // _LANES
    lane = torch.clamp(slot, min=0) % _LANES
    set_word = bits[word] | (torch.ones_like(lane) << lane)
    new_bits = bits.clone()
    new_bits[word] = torch.where(any_free, set_word, bits[word])
    return new_bits, slot.to(torch.int32)


def release(bits: torch.Tensor, slot) -> torch.Tensor:
    slot = torch.as_tensor(slot, dtype=torch.int64, device=bits.device)
    word, lane = slot // _LANES, slot % _LANES
    new_bits = bits.clone()
    new_bits[word] = bits[word] & ~(torch.ones_like(lane) << lane)
    return new_bits


def is_claimed(bits: torch.Tensor, slot) -> torch.Tensor:
    slot = torch.as_tensor(slot, dtype=torch.int64, device=bits.device)
    word, lane = slot // _LANES, slot % _LANES
    return ((bits[word] >> lane) & 1) == 1


def count(bits: torch.Tensor) -> torch.Tensor:
    return _bits(bits).sum().to(torch.int32)
