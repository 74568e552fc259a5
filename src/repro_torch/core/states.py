"""Finite-state machines with lock-free CAS transitions.

Refactoring step (4) of the paper: boolean validity flags on request and
queue-entry objects were replaced by explicit finite state machines whose
transitions are performed with atomic compare-and-swap — "verify with atomic
compare-and-swap that an object is in the expected state before changing to
the next state" (Section 3, Figures 3 and 4).

The two FSMs from the paper are reproduced (with one extension):

  Request:  FREE -> VALID -> {RECEIVED -> {COMPLETED, CANCELLED},
                              COMPLETED, CANCELLED}
            COMPLETED -> FREE, CANCELLED -> FREE
  Buffer:   FREE -> RESERVED -> ALLOCATED -> {RECEIVED -> FREE,
                                              PREEMPTED -> {ALLOCATED,
                                                            FREE}}

The RECEIVED -> CANCELLED edge extends the paper's Figure 3 for
client-initiated cancellation of an *in-service* request (the streaming
session API): the client's ``cancel()`` races the server's completion
with a single CAS, so exactly one of COMPLETED/CANCELLED wins and the
server releases resources exactly once either way.  The buffer FSM
likewise gains a RESERVED -> FREE edge so a chunked admission whose
prompt is still streaming into the cache can be aborted without ever
reaching ALLOCATED (DESIGN.md §9), and a PREEMPTED state for the
overload-control subsystem (DESIGN.md §12): an ALLOCATED sequence whose
private KV pages were swapped host-side parks in PREEMPTED, resumes via
PREEMPTED -> ALLOCATED when pages are re-claimed, or exits via
PREEMPTED -> FREE when the client cancels it while parked.

A third, two-state FSM backs the MCAPI-style non-blocking operation
handles (``repro_torch.core.transport.OpHandle``):

  Op:       PENDING -> {COMPLETED, CANCELLED}          (both terminal)

Host CAS primitive: CPython has no compare-exchange bytecode, so we build
consensus from the one atomic read-modify-write it does give us —
``list.append``.  Each cell keeps an append-only journal of *proposed*
transitions; folding the journal deterministically decides which proposals
won.  Append-only logs are a classic lock-free construction (every proposer
completes in a bounded number of steps; the journal is compacted by the
winner).  The serving engine and async checkpointer use these cells for
request lifecycle tracking.
"""
from __future__ import annotations

import itertools
from typing import Dict, FrozenSet, Tuple

from repro_torch.core import interleave as _il

# --- Request FSM (paper Figure 3) ------------------------------------------
REQUEST_FREE = "REQUEST_FREE"
REQUEST_VALID = "REQUEST_VALID"
REQUEST_RECEIVED = "REQUEST_RECEIVED"
REQUEST_COMPLETED = "REQUEST_COMPLETED"
REQUEST_CANCELLED = "REQUEST_CANCELLED"

REQUEST_TRANSITIONS: Dict[str, FrozenSet[str]] = {
    REQUEST_FREE: frozenset({REQUEST_VALID}),
    REQUEST_VALID: frozenset({REQUEST_RECEIVED, REQUEST_COMPLETED,
                              REQUEST_CANCELLED}),
    REQUEST_RECEIVED: frozenset({REQUEST_COMPLETED, REQUEST_CANCELLED}),
    REQUEST_COMPLETED: frozenset({REQUEST_FREE}),
    REQUEST_CANCELLED: frozenset({REQUEST_FREE}),
}

# --- Queue-entry / buffer FSM (paper Figure 4) ------------------------------
BUFFER_FREE = "BUFFER_FREE"
BUFFER_RESERVED = "BUFFER_RESERVED"
BUFFER_ALLOCATED = "BUFFER_ALLOCATED"
BUFFER_RECEIVED = "BUFFER_RECEIVED"
BUFFER_PREEMPTED = "BUFFER_PREEMPTED"

BUFFER_TRANSITIONS: Dict[str, FrozenSet[str]] = {
    BUFFER_FREE: frozenset({BUFFER_RESERVED}),
    # RESERVED -> FREE extends Figure 4 for chunked admission (DESIGN.md
    # §9): a slot whose prompt is still streaming in (pages claimed,
    # cache rows only partially materialized) can be aborted — client
    # cancel or mid-stream pool exhaustion — without ever having been
    # ALLOCATED.  The release is a single CAS, same as every other edge.
    BUFFER_RESERVED: frozenset({BUFFER_ALLOCATED, BUFFER_FREE}),
    # ALLOCATED -> PREEMPTED extends Figure 4 for overload control
    # (DESIGN.md §12): a decoding sequence's private KV pages are
    # swapped host-side and the cell parks until pages can be
    # re-claimed (PREEMPTED -> ALLOCATED, the resume) or the client
    # cancels it while parked (PREEMPTED -> FREE).  The cell travels
    # with the parked sequence, not the decode slot.
    BUFFER_ALLOCATED: frozenset({BUFFER_RECEIVED, BUFFER_PREEMPTED}),
    BUFFER_RECEIVED: frozenset({BUFFER_FREE}),
    BUFFER_PREEMPTED: frozenset({BUFFER_ALLOCATED, BUFFER_FREE}),
}

# --- Operation-handle FSM (MCAPI mcapi_test/mcapi_wait/mcapi_cancel) --------
OP_PENDING = "OP_PENDING"
OP_COMPLETED = "OP_COMPLETED"
OP_CANCELLED = "OP_CANCELLED"

OP_TRANSITIONS: Dict[str, FrozenSet[str]] = {
    OP_PENDING: frozenset({OP_COMPLETED, OP_CANCELLED}),
    OP_COMPLETED: frozenset(),          # terminal
    OP_CANCELLED: frozenset(),          # terminal
}


class IllegalTransition(RuntimeError):
    pass


_seq = itertools.count()  # itertools.count() is thread-safe in CPython


_COMPACT_AT = 64


class StateCell:
    """A lock-free CAS cell over a fixed transition table.

    ``cas(expected, new)`` returns True iff this caller's proposal is the one
    that moved the cell from ``expected`` to ``new``.  Multiple threads may
    race; exactly one wins per state occupancy.  Progress is lock-free: an
    append always completes, and deciding the winner is a pure fold.

    Representation: ``_journal`` is ONE append-only list of proposals
    ``[seq, expected, new, resolved]`` that is never replaced, so an
    append can never land in an abandoned list.  ``_base`` is an
    immutable pair ``(folded_state, folded_entries)`` stored as ONE
    attribute write; a fold starts from ``folded_state`` and replays
    every journal entry that is not (by identity) in ``folded_entries``.
    A fold is authoritative iff ``_base`` is unchanged when it finishes.

    Compaction (bounding the journal) is where two earlier versions of
    this cell had genuine lost-update races, both found by the
    deterministic interleaving checker:

    * The original two-store design (preserved as
      the reference checker's ``LegacyStateCell``) wrote the folded base
      and the truncated journal as separate stores — a proposal folded
      between them replayed against a doubled history.
    * The second design swapped an immutable ``(base, journal[k:])``
      pair atomically, but the suffix copy and the swap were two steps:
      a proposal appended between them passed its currency check (the
      pair was still current), reported a WIN, and was then orphaned by
      the swap — schedule ``[1,1,1,1,1,1,0,0,0,0,0,1]`` of the
      ``statecell_compaction`` scenario loses a committed transition
      (the minimized schedule lives in ``tests/schedules/``).

    The watermark protocol here closes both windows:

      * a proposal is marked ``resolved`` only after its caller's
        authoritative fold, and the compactor folds ONLY the longest
        resolved prefix — it can never fold an entry whose owner has
        not yet seen the outcome (an unresolved entry also blocks every
        entry behind it, so position order is preserved);
      * the compactor installs ``(prefix_state, prefix_entries)`` as
        one atomic store and only THEN deletes the prefix from the
        journal (``del j[:k]`` — a single slice-delete).  Between the
        two, folds skip the prefix entries by identity, so both orders
        of the interim window read the same state.  ``_base`` keeps the
        folded entries alive, so their ids cannot be recycled while the
        skip set still matters;
      * a single-compactor guard (the ``setdefault`` CAS primitive)
        keeps rival compactions from interleaving; losers skip —
        compaction is opportunistic, so skipping is progress.
    """

    __slots__ = ("_table", "_base", "_journal", "_name", "_cguard",
                 "_compact_at")

    def __init__(self, table: Dict[str, FrozenSet[str]], initial: str,
                 name: str = "", compact_at: int = _COMPACT_AT):
        if initial not in table:
            raise ValueError(f"unknown state {initial!r}")
        self._table = table
        self._base: tuple = (initial, ())
        self._journal: list = []          # [[seq, expected, new, resolved]]
        self._name = name
        self._cguard: dict = {}
        self._compact_at = compact_at

    def _fold_once(self) -> Tuple[tuple, str, set]:
        """One fold pass: (base-read, folded state, winner seqs)."""
        base = self._base
        state = base[0]
        skip = {id(e) for e in base[1]}
        winners = set()
        for e in list(self._journal):
            if id(e) in skip:             # already folded into the base
                continue
            if e[1] == state and e[2] in self._table[state]:
                state = e[2]
                winners.add(e[0])
        return base, state, winners

    def _fold_current(self) -> Tuple[str, set]:
        """Fold base + journal; retry if a compaction moved the base
        mid-fold (our journal snapshot may then miss folded entries
        whose effect the stale base did not carry)."""
        while True:
            if _il._active is not None:
                _il._active.yield_point("states.fold", id(self))
            base, state, winners = self._fold_once()
            if _il._active is not None:
                _il._active.yield_point("states.fold.verify", id(self))
            if self._base is base:
                return state, winners

    @property
    def state(self) -> str:
        return self._fold_current()[0]

    def cas(self, expected: str, new: str) -> bool:
        if new not in self._table.get(expected, frozenset()):
            raise IllegalTransition(
                f"{self._name}: {expected} -> {new} not in transition table")
        seq = next(_seq)
        entry = [seq, expected, new, False]
        if _il._active is not None:
            _il._active.yield_point("states.append", id(self))
        self._journal.append(entry)       # atomic append = consensus order
        # Our own entry is unresolved, so no compactor can fold or delete
        # it before the authoritative fold below returns its verdict.
        won = entry[0] in self._fold_current()[1]
        if _il._active is not None:
            _il._active.yield_point("states.resolve", id(self))
        entry[3] = True                   # compactable from here on
        if len(self._journal) > self._compact_at:
            self._maybe_compact()
        return won

    def _maybe_compact(self) -> None:
        """Fold the longest resolved journal prefix into the base with
        one atomic store, then drop the prefix — opportunistic,
        single-compactor, and unable to touch an unresolved (in-flight)
        proposal by construction."""
        tok = object()
        if _il._active is not None:
            _il._active.yield_point("states.compact.guard", id(self))
        if self._cguard.setdefault("c", tok) is not tok:
            return                        # a rival compactor is active
        try:
            j = self._journal
            k = 0
            while k < len(j) and j[k][3]:
                k += 1
            if k == 0:
                return
            prefix = tuple(j[:k])
            base = self._base             # stable: we hold the guard
            state = base[0]
            skip = {id(e) for e in base[1]}
            for e in prefix:
                if id(e) in skip:         # defensive; prior del precedes
                    continue              # guard release, so never hit
                if e[1] == state and e[2] in self._table[state]:
                    state = e[2]
            if _il._active is not None:
                _il._active.yield_point("states.compact.swap", id(self))
            self._base = (state, prefix)  # ONE atomic store installs both
            if _il._active is not None:
                _il._active.yield_point("states.compact.del", id(self))
            del j[:k]                     # cleanup; folds skip by identity
        finally:
            self._cguard.pop("c", None)

    def transition(self, expected: str, new: str) -> None:
        if not self.cas(expected, new):
            raise IllegalTransition(
                f"{self._name}: lost CAS {expected} -> {new} "
                f"(actual state {self.state})")

    # -- pickling (crash-recovery snapshots) --------------------------------
    # A cell serializes as its folded state plus the NAME of its transition
    # table: the journal is history, not state, so it compacts to nothing,
    # and unpickling rebinds the canonical module-level table object (table
    # identity matters — a deep-copied table would defeat `is` comparisons
    # and bloat every snapshot with the same frozen dict).

    def __getstate__(self):
        table_name = _TABLE_NAMES.get(id(self._table))
        if table_name is None:
            raise TypeError(
                f"{self._name}: cannot pickle a StateCell over a "
                f"non-canonical transition table")
        return (table_name, self.state, self._name)

    def __setstate__(self, state):
        table_name, folded, name = state
        self._table = _TABLES[table_name]
        self._base = (folded, ())
        self._journal = []
        self._name = name
        self._cguard = {}
        self._compact_at = _COMPACT_AT


_TABLES: Dict[str, Dict[str, FrozenSet[str]]] = {
    "REQUEST": REQUEST_TRANSITIONS,
    "BUFFER": BUFFER_TRANSITIONS,
    "OP": OP_TRANSITIONS,
}
_TABLE_NAMES = {id(t): n for n, t in _TABLES.items()}


def request_cell(name: str = "request") -> StateCell:
    return StateCell(REQUEST_TRANSITIONS, REQUEST_FREE, name)


def buffer_cell(name: str = "buffer") -> StateCell:
    return StateCell(BUFFER_TRANSITIONS, BUFFER_FREE, name)


def op_cell(name: str = "op") -> StateCell:
    return StateCell(OP_TRANSITIONS, OP_PENDING, name)
