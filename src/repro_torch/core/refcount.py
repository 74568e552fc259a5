"""Lock-free reference-counted slot array — the bitset, generalized.

The paper's refactoring step (3) replaced a lock-free linked list with a
lock-free *bit set* because the pool only needed claim/release — a binary
own/free discipline.  Prefix-shared KV pages break that binary: one
physical page can back many sequences' block-table rows at once, plus the
prefix cache's own residency, so the allocator must count owners.  This
module is the bitset's refcounted generalization with the same
non-blocking contract:

  * ``try_claim``   — CAS claim-from-zero (a free slot becomes count 1)
  * ``incref``      — fetch-add share (a held slot gains an owner)
  * ``decref``      — fetch-sub release; the slot returns to the free set
                      exactly when the count reaches zero

CPython gives no atomic integer fetch-add, so the count is *represented*
rather than stored: each slot holds a dict of unique reference tokens and
the count IS ``len()`` of that dict.  Inserting a fresh token
(``d[object()] = None``) and ``popitem()`` are single atomic dict
operations under the GIL, so incref/decref are wait-free and never lose
an update — two racing increfs insert two distinct keys; two racing
decrefs pop two distinct items.

Claim-from-zero is the one transition that must be mutually exclusive
*between claimers*: two threads observing ``len == 0`` must not both
insert a first token.  A per-slot setdefault-CAS guard (the HostBitset
primitive) serializes claimers only — a claimer that loses the guard
probes the next slot, never blocks.  Holders never touch the guard, and
when a slot's count is zero there are no holders by definition (sharing
requires already holding a reference), so the guarded claim races only
against other claimers — which is exactly what the guard excludes.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core import interleave as _il

_MISSING = object()


class RefCountArray:
    """Lock-free refcounted slot allocator (multi-thread safe).

    The free set is implicit: slot ``i`` is free iff its count is zero.
    ``release`` is an alias for ``decref`` so the array is drop-in for
    the bitset allocator's ``HostBitset`` in single-owner use — a page
    that was never shared releases straight back to the free set.
    """

    __slots__ = ("_n", "_refs", "_claiming")

    def __init__(self, nslots: int):
        self._n = nslots
        # slot -> {token: None}; the count of slot i is len(self._refs[i]).
        self._refs = [dict() for _ in range(nslots)]
        # slot -> claimer token; serializes claim-from-zero attempts only.
        self._claiming: dict = {}

    @property
    def capacity(self) -> int:
        return self._n

    # -- claim-from-zero (CAS) ---------------------------------------------
    def try_claim(self, owner: object = True, start: int = 0
                  ) -> Optional[int]:
        """Claim any free slot (count 0 -> 1); index or None when all held.

        Obstruction-free probing like ``HostBitset.try_claim``: a probe
        that loses the per-slot guard or finds the slot referenced moves
        on; some claimer always makes progress.  ``owner`` is accepted
        for signature compatibility; references are anonymous tokens.
        """
        del owner
        n = self._n
        for off in range(n):
            i = (start + off) % n
            if _il._active is not None:
                _il._active.yield_point("refcount.probe", (id(self), i))
            if not self._refs[i] and self.claim_specific(i):
                return i
        return None

    def claim_specific(self, i: int) -> bool:
        """CAS claim slot ``i`` iff it is free.  True when we took it."""
        tok = object()
        if _il._active is not None:
            _il._active.yield_point("refcount.guard", (id(self), i))
        if self._claiming.setdefault(i, tok) is not tok:
            return False           # another claimer holds the guard
        try:
            if _il._active is not None:
                _il._active.yield_point("refcount.check", (id(self), i))
            if self._refs[i]:      # referenced -> not free, claim fails
                return False
            # No holders exist (count == 0) and rival claimers are
            # excluded by the guard: inserting the first reference is
            # race-free.
            if _il._active is not None:
                _il._active.yield_point("refcount.insert", (id(self), i))
            self._refs[i][object()] = None
            return True
        finally:
            if _il._active is not None:
                _il._active.yield_point("refcount.unguard", (id(self), i))
            self._claiming.pop(i, None)

    # -- share / release (fetch-add / fetch-sub) ---------------------------
    def incref(self, i: int) -> int:
        """Share a held slot; returns the new count.

        Contract: the caller already holds a reference to ``i`` (you can
        only share what you own), so the count stays >= 1 throughout and
        cannot race a concurrent return-to-free.
        """
        d = self._refs[i]
        if not d:
            raise KeyError(f"slot {i} is free; incref requires a holder")
        if _il._active is not None:
            _il._active.yield_point("refcount.incref", (id(self), i))
        d[object()] = None         # unique key: atomic, never lost
        return len(d)

    def decref(self, i: int) -> int:
        """Drop one reference; returns the remaining count.  The slot
        re-enters the free set exactly when this returns 0 — there is no
        separate "free" step to forget or double-run."""
        if _il._active is not None:
            _il._active.yield_point("refcount.decref", (id(self), i))
        try:
            self._refs[i].popitem()    # atomic removal of one reference
        except KeyError:
            raise KeyError(f"slot {i} is free; decref without a reference")
        return len(self._refs[i])

    # HostBitset-compatible surface --------------------------------------
    def release(self, i: int) -> None:
        self.decref(i)

    def refcount(self, i: int) -> int:
        return len(self._refs[i])

    def is_claimed(self, i: int) -> bool:
        return bool(self._refs[i])

    def count(self) -> int:
        """Number of *held* slots (each counted once however shared)."""
        return sum(1 for d in self._refs if d)

    def shared_count(self) -> int:
        """Number of slots currently held by more than one reference."""
        return sum(1 for d in self._refs if len(d) > 1)
