"""Pure sequential specifications of the lock-free core's semantics.

Each spec is the *abstract* data type a structure claims to implement:
a state machine over hashable states whose ``apply(state, op, args)``
enumerates every ``(next_state, result)`` the sequential type could
produce.  The linearizability checker (:mod:`repro_torch.checker.lin`)
validates recorded concurrent histories against these.

Two deliberate spec-strength decisions, written down here because they
encode *proofs about the implementations*, not checker convenience:

* **SPSC refusals are strict.**  ``HostNBB`` reads its peer counter
  once while its own counter is frozen (it owns it), so the occupancy
  it computes was the true occupancy at the instant of the peer-counter
  load — a FULL/EMPTY refusal really happened at a point inside the
  operation where the ring was full/empty.  The same argument covers
  the MPSC fan-in's EMPTY: only the scanning consumer removes items, so
  if every ring looked empty during the scan, all were simultaneously
  empty at the first probe.  The spec therefore only admits refusals in
  genuinely full/empty abstract states — a refusal under other
  conditions is a real linearizability bug and will be reported.

* **Scan-allocator refusals are weak.**  ``HostBitset.try_claim`` /
  ``RefCountArray.try_claim`` probe slots one CAS at a time while OTHER
  threads claim and release concurrently; a full scan can fail even
  though at every instant some slot was free (the classic weak-scan
  counterexample), so a ``None`` refusal is admitted in any state.
  Successful claims, increfs and releases remain strict.

* **Partial bursts are weak.**  A burst op is not atomic by design: its
  acceptance count ``m`` is decided at the peer-counter load, but the
  items land at the commit/ack store, and the peer can legally change
  occupancy in between (the checker exhibits ``send_burst -> (FULL, 1)``
  with a concurrent drain making space before the commit).  So
  ``(FULL, m)`` with ``0 < m < len(vals)`` and a drain returning fewer
  than ``max_n`` items are admitted whenever the *transfer itself* fits
  the abstract state.  Full acceptance, zero-item FULL refusals and
  empty drains involve a single decisive load and stay strict.
"""
from __future__ import annotations

from typing import Any, Iterable, Tuple

from repro_torch.core import nbb
from repro_torch.checker.lin import MISSING

# ---------------------------------------------------------------------------
# Status normalization: Table-1 codes collapse to their class, because
# transient vs stable (is the peer mid-op?) is timing, not semantics.
# ---------------------------------------------------------------------------
FULL_STATUSES = frozenset({nbb.BUFFER_FULL,
                           nbb.BUFFER_FULL_BUT_CONSUMER_READING})
EMPTY_STATUSES = frozenset({nbb.BUFFER_EMPTY,
                            nbb.BUFFER_EMPTY_BUT_PRODUCER_INSERTING})


def status_class(status: int) -> str:
    if status == nbb.OK:
        return "OK"
    if status in FULL_STATUSES:
        return "FULL"
    if status in EMPTY_STATUSES:
        return "EMPTY"
    raise ValueError(f"unknown status {status}")


class SpscRingSpec:
    """Bounded FIFO — the HostNBB abstract type.

    Ops: ``("send", item) -> "OK" | "FULL"``,
    ``("recv",) -> ("OK", item) | ("EMPTY", None)``,
    ``("send_burst", items) -> (class, n_accepted)``,
    ``("drain", max_n) -> (item, ...)``.
    State: tuple of queued items, oldest first.
    """

    def __init__(self, capacity: int):
        self.capacity = capacity

    def init(self) -> Tuple:
        return ()

    def apply(self, state: Tuple, op: str, args: Tuple
              ) -> Iterable[Tuple[Any, Any]]:
        if op == "send":
            if len(state) >= self.capacity:
                yield state, "FULL"
            else:
                yield state + (args[0],), "OK"
        elif op == "recv":
            if state:
                yield state[1:], ("OK", state[0])
            else:
                yield state, ("EMPTY", None)
        elif op == "send_burst":
            vals = tuple(args[0])
            space = self.capacity - len(state)
            if len(vals) <= space:
                yield state + vals, ("OK", len(vals))   # strict: all fit
            if space == 0 and vals:
                yield state, ("FULL", 0)                # strict: truly full
            # Weak partial acceptance (module docstring): the occupancy
            # snapshot that limited the burst to m < len(vals) items is
            # taken at the peer-counter load, but the insertion lands at
            # the commit, after concurrent drains may have widened space
            # — ("FULL", m) is admitted whenever the m-item prefix fits.
            for m in range(1, len(vals)):
                if m <= space:
                    yield state + vals[:m], ("FULL", m)
        elif op == "drain":
            max_n = args[0]
            avail = len(state) if max_n is None else min(max_n, len(state))
            yield state[avail:], tuple(state[:avail])   # strict full take
            # Weak partial takes: availability is snapshotted at the
            # update-counter load; removal lands at the ack, by which
            # time the producer may have committed more items — any
            # shorter nonempty prefix is admissible.
            for m in range(1, avail):
                yield state[m:], tuple(state[:m])
        else:
            raise ValueError(f"SpscRingSpec: unknown op {op!r}")


class MpscSpec:
    """Fan-in of per-producer FIFOs — the MpscQueue abstract type.

    ``("send", pid, item)`` appends to producer ``pid``'s queue;
    ``("recv",)`` nondeterministically pops the head of ANY nonempty
    queue (the consumer's round-robin order is a fairness policy, not a
    semantic guarantee — only per-producer FIFO is promised).  EMPTY is
    strict (single consumer; see module docstring).
    """

    def __init__(self, nproducers: int, capacity_per_producer: int):
        self.n = nproducers
        self.capacity = capacity_per_producer

    def init(self) -> Tuple:
        return tuple(() for _ in range(self.n))

    def apply(self, state: Tuple, op: str, args: Tuple
              ) -> Iterable[Tuple[Any, Any]]:
        if op == "send":
            pid, item = args
            q = state[pid]
            if len(q) >= self.capacity:
                yield state, "FULL"
            else:
                yield (state[:pid] + (q + (item,),) + state[pid + 1:]), "OK"
        elif op == "recv":
            any_nonempty = False
            for pid in range(self.n):
                q = state[pid]
                if q:
                    any_nonempty = True
                    yield (state[:pid] + (q[1:],) + state[pid + 1:]), \
                        ("OK", q[0])
            if not any_nonempty:
                yield state, ("EMPTY", None)
        else:
            raise ValueError(f"MpscSpec: unknown op {op!r}")


class RefCountSpec:
    """Refcounted slot allocator — the RefCountArray abstract type.

    State: tuple of per-slot counts.  Weak refusals (see module
    docstring): ``try_claim -> None`` and ``claim_specific -> False``
    are admitted in any state (losing the guard to a rival claimer is
    legal obstruction even when the slot stays free).  Counts returned
    by incref/decref are recorded as MISSING by scenarios — the value
    is read after the atomic insert/pop, so it may include neighbors'
    updates; the *count trajectory* is validated by final-state
    invariants instead.
    """

    def __init__(self, nslots: int):
        self.n = nslots

    def init(self) -> Tuple:
        return tuple(0 for _ in range(self.n))

    def _set(self, state: Tuple, i: int, v: int) -> Tuple:
        return state[:i] + (v,) + state[i + 1:]

    def apply(self, state: Tuple, op: str, args: Tuple
              ) -> Iterable[Tuple[Any, Any]]:
        if op == "try_claim":
            for i in range(self.n):
                if state[i] == 0:
                    yield self._set(state, i, 1), i
            yield state, None                     # weak refusal
        elif op == "claim_specific":
            i = args[0]
            if state[i] == 0:
                yield self._set(state, i, 1), True
            yield state, False                    # weak refusal
        elif op == "incref":
            i = args[0]
            if state[i] >= 1:
                yield self._set(state, i, state[i] + 1), MISSING
        elif op == "decref":
            i = args[0]
            if state[i] >= 1:
                yield self._set(state, i, state[i] - 1), MISSING
        else:
            raise ValueError(f"RefCountSpec: unknown op {op!r}")


class BitsetSpec:
    """Binary claim/release allocator — the HostBitset abstract type.
    Same weak-refusal policy as :class:`RefCountSpec`."""

    def __init__(self, nslots: int):
        self.n = nslots

    def init(self) -> Tuple:
        return tuple(False for _ in range(self.n))

    def _set(self, state: Tuple, i: int, v: bool) -> Tuple:
        return state[:i] + (v,) + state[i + 1:]

    def apply(self, state: Tuple, op: str, args: Tuple
              ) -> Iterable[Tuple[Any, Any]]:
        if op == "try_claim":
            for i in range(self.n):
                if not state[i]:
                    yield self._set(state, i, True), i
            yield state, None                     # weak refusal
        elif op == "claim_specific":
            i = args[0]
            if not state[i]:
                yield self._set(state, i, True), True
            yield state, False                    # weak refusal
        elif op == "release":
            i = args[0]
            if state[i]:
                yield self._set(state, i, False), MISSING
        else:
            raise ValueError(f"BitsetSpec: unknown op {op!r}")


class FsmSpec:
    """CAS cell over a transition table — the StateCell abstract type.

    ``("cas", expected, new)``: atomic compare-and-swap semantics — a
    CAS linearized in state ``expected`` MUST succeed, one linearized
    anywhere else MUST fail.  This strictness is what convicts the
    legacy journal-compaction race: a cas that reported a win whose
    transition later evaporated leaves a history no sequential CAS cell
    can produce.  ``("read",)`` returns the current state.
    """

    def __init__(self, table: dict, initial: str):
        self.table = table
        self.initial = initial

    def init(self) -> str:
        return self.initial

    def apply(self, state: str, op: str, args: Tuple
              ) -> Iterable[Tuple[Any, Any]]:
        if op == "cas":
            expected, new = args
            if state == expected and new in self.table[state]:
                yield new, True
            else:
                yield state, False
        elif op == "read":
            yield state, state
        else:
            raise ValueError(f"FsmSpec: unknown op {op!r}")


class PriorityFanSpec:
    """Per-class FIFO fan — the PriorityTransport abstract type at the
    linearizability level: ``("send", cls, item)`` / ``("recv",)`` with
    nondeterministic class choice on recv.  The *priority* policy
    (lowest nonempty class first) is an interval property the scan only
    guarantees against items committed before the scan began, so it is
    validated by scenario invariants over preloaded items, not here.
    """

    def __init__(self, nclasses: int, capacity_per_class: int):
        self._inner = MpscSpec(nclasses, capacity_per_class)

    def init(self) -> Tuple:
        return self._inner.init()

    def apply(self, state, op, args):
        return self._inner.apply(state, op, args)
