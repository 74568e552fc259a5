"""Trace detectors for the NBB epoch protocol: torn reads / happens-before.

The scheduler's yield trace records each shared access twice over, in
effect: a task *parks* at a site immediately BEFORE performing the
access, and the access then executes at the start of the task's next
scheduled segment — i.e. just before the task's NEXT trace event.  So
every instrumented access owns an interval in trace positions::

    [event index where the task parked,  index of the task's next event]

during which the access is pending-or-executing.

The NBB Safety property (paper §3: "a successful read never observes a
partially-written slot") is slot disjointness: the producer's write to
slot ``i`` and the consumer's read of slot ``i`` must never be in
flight at the same time — the epoch counters (odd = in-flight) are
precisely the mechanism that keeps the consumer from addressing a slot
before the write's commit store lands.  In interval terms: a write
access to ``(ring, i)`` and a read access to ``(ring, i)`` with
overlapping intervals is a happens-before violation (a torn read in a
memory model with non-atomic slot stores).

Under the correct protocol no overlap can occur: the consumer only
computes a readable index from a committed update count, and the
commit store executes strictly after the write interval closes.  The
detector's sensitivity is validated by the ``broken_ring`` scenario
(commit store before slot write), which it must convict.
"""
from __future__ import annotations

import dataclasses
from typing import Any, FrozenSet, List, Sequence, Tuple

#: Sites whose pending access WRITES ring slots, with their span decoder.
_WRITE_SITES = frozenset({"nbb.send.slot", "nbb.burst.copy"})
#: Sites whose pending access READS ring slots.
_READ_SITES = frozenset({"nbb.recv.slot", "nbb.drain.copy"})


def _span(site: str, info: Any) -> Tuple[int, FrozenSet[int]]:
    """(ring id, slot indices) touched by the access parked at ``site``."""
    if site in ("nbb.send.slot", "nbb.recv.slot"):
        ring, idx = info
        return ring, frozenset((idx,))
    ring, start, m, n = info                     # burst copy span, may wrap
    return ring, frozenset((start + j) % n for j in range(m))


@dataclasses.dataclass(frozen=True)
class TornRead:
    ring: int
    slots: Tuple[int, ...]
    writer_task: int
    reader_task: int
    writer_event: int            # trace index where the write parked
    reader_event: int

    def __str__(self) -> str:
        return (f"torn read: task {self.reader_task} read slot(s) "
                f"{list(self.slots)} of ring {self.ring:#x} while task "
                f"{self.writer_task}'s write was in flight "
                f"(write parked at trace[{self.writer_event}], "
                f"read parked at trace[{self.reader_event}])")


class TornReadDetected(AssertionError):
    """Raised by scenario checks when the detector finds a violation."""


def find_torn_reads(trace: Sequence[Tuple[int, str, Any]]) -> List[TornRead]:
    """All same-slot write/read interval overlaps in a yield trace."""
    n = len(trace)
    # next_own[k] = index of the same task's next event (n when final:
    # instrumented ring accesses are always followed by a commit/ack
    # park, so a ring access interval never actually reaches n).
    next_own = [n] * n
    last: dict = {}
    for k in range(n - 1, -1, -1):
        tid = trace[k][0]
        next_own[k] = last.get(tid, n)
        last[tid] = k

    writes: List[Tuple[int, FrozenSet[int], int, int, int]] = []
    reads: List[Tuple[int, FrozenSet[int], int, int, int]] = []
    for k, (tid, site, info) in enumerate(trace):
        if site in _WRITE_SITES:
            ring, slots = _span(site, info)
            writes.append((ring, slots, tid, k, next_own[k]))
        elif site in _READ_SITES:
            ring, slots = _span(site, info)
            reads.append((ring, slots, tid, k, next_own[k]))

    out: List[TornRead] = []
    for w_ring, w_slots, w_tid, w_beg, w_end in writes:
        for r_ring, r_slots, r_tid, r_beg, r_end in reads:
            if w_ring != r_ring or w_tid == r_tid:
                continue
            if w_beg < r_end and r_beg < w_end:          # intervals overlap
                hit = w_slots & r_slots
                if hit:
                    out.append(TornRead(
                        ring=w_ring, slots=tuple(sorted(hit)),
                        writer_task=w_tid, reader_task=r_tid,
                        writer_event=w_beg, reader_event=r_beg))
    return out


def assert_no_torn_reads(trace: Sequence[Tuple[int, str, Any]],
                         label: str = "") -> None:
    """The form scenario ``check`` hooks use."""
    found = find_torn_reads(trace)
    if found:
        raise TornReadDetected(
            f"{label}: {len(found)} torn read(s); first: {found[0]}")
