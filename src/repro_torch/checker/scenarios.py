"""Model-checking scenarios over the lock-free core.

Each scenario is a factory returning a fresh :class:`repro_torch.core.interleave.World`:
a small, *bounded* cast of tasks exercising one structure through its
instrumented yield points, plus the invariants that convict a bad
interleaving — a linearizability check against the structure's
sequential spec (:mod:`repro_torch.checker.specs`), the torn-read detector
(:mod:`repro_torch.checker.detectors`), and scenario-specific assertions
(exactly-one-winner, committed-prefix-only delivery, ...).

Design rules every scenario follows:

* **Tasks are finite under EVERY schedule.**  Consumers make a fixed
  number of poll attempts rather than spinning until satisfied — an
  unfair schedule must not be able to livelock a task.  *Completeness*
  (every accepted item eventually delivered) is then asserted in the
  ``check`` hook, which runs disarmed after all tasks finish and can
  drain sequentially.
* **All task-visible state is in the fingerprint.**  Results are routed
  through the shared :class:`repro_torch.checker.lin.Recorder` (or shared
  lists), and the fingerprint covers structure internals + recorder
  events + flags, so DFS state-pruning is sound.
* **Two scenarios are deliberately broken** (``expect="violation"``):
  ``broken_ring`` validates the torn-read detector's sensitivity, and
  ``legacy_statecell_compaction`` preserves the journal-compaction
  lost-update race this checker found in the original ``StateCell``
  (fixed in ``repro_torch.core.states``; the minimized schedule lives in
  ``tests/schedules/`` as a regression).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core import faults, nbb, states, transport
from repro_torch.core import interleave as il
from repro_torch.core.bitset import HostBitset
from repro_torch.core.host_queue import MpscQueue
from repro_torch.core.nbb import HostNBB
from repro_torch.core.refcount import RefCountArray
from repro_torch.checker import detectors, specs
from repro_torch.checker.lin import MISSING, Recorder, assert_linearizable


# ---------------------------------------------------------------------------
# Fingerprint helpers: hashable snapshots of structure internals.
# ---------------------------------------------------------------------------
def ring_fp(r: HostNBB) -> Tuple:
    return (r._uc, r._ac, tuple(r._slots))


def mpsc_fp(q: MpscQueue) -> Tuple:
    return (tuple(ring_fp(r) for r in q._rings), q._cursor)


def refcount_fp(rc: RefCountArray) -> Tuple:
    return (tuple(len(d) for d in rc._refs), tuple(sorted(rc._claiming)))


def bitset_fp(b: HostBitset) -> Tuple:
    return tuple(sorted(b._claims))


def cell_fp(c: states.StateCell) -> Tuple:
    # Seqs come from a process-global counter, so they differ across DFS
    # re-executions of the same logical state; rank them journal-locally
    # to keep fingerprints execution-stable (pruning soundness only needs
    # relative order + identity of each entry's verdict bits).
    base = c._base
    journal = list(c._journal)
    rank = {s: i for i, s in enumerate(sorted(e[0] for e in journal))}
    folded = {id(e) for e in base[1]}
    return (base[0],
            tuple((rank[e[0]], e[1], e[2], e[3], id(e) in folded)
                  for e in journal),
            tuple(sorted(c._cguard)))


@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    make_world: Callable[[], il.World]
    expect: str                       # "pass" | "violation"
    structure: str                    # which primitive it validates
    #: suggested exhaustive budget (max_executions) for a full explore
    explore_budget: int = 4000
    max_steps: int = 400


SCENARIOS: Dict[str, Scenario] = {}


def _register(name: str, expect: str, structure: str,
              explore_budget: int = 4000, max_steps: int = 400):
    def deco(fn: Callable[[], il.World]) -> Callable[[], il.World]:
        SCENARIOS[name] = Scenario(name=name, make_world=fn, expect=expect,
                                   structure=structure,
                                   explore_budget=explore_budget,
                                   max_steps=max_steps)
        return fn
    return deco


def get(name: str) -> Scenario:
    return SCENARIOS[name]


# ---------------------------------------------------------------------------
# SPSC ring: scalar protocol.
# ---------------------------------------------------------------------------
@_register("spsc_scalar", "pass", "HostNBB")
def spsc_scalar() -> il.World:
    """1 producer x 3 sends, 1 consumer x 4 bounded polls on a 2-slot
    ring: every counter announce/commit interleaving of the scalar
    protocol.  Lin vs the strict SPSC spec + torn-read detection +
    completeness (accepted items all delivered, in order)."""
    ring = HostNBB(2)
    rec = Recorder()
    world = il.World(tasks=[], fingerprint=None, check=None)

    def producer() -> None:
        for item in (10, 11, 12):
            opid = rec.invoke("p", "send", item)
            rec.respond(opid, specs.status_class(ring.insert_item(item)))

    def consumer() -> None:
        for _ in range(4):
            opid = rec.invoke("c", "recv")
            st, got = ring.read_item()
            rec.respond(opid, (specs.status_class(st), got))

    def check() -> None:
        detectors.assert_no_torn_reads(world.trace, "spsc_scalar")
        # Completeness: what the consumer missed is still in the ring.
        leftover = ring.drain()
        for item in leftover:
            opid = rec.invoke("main", "recv")
            rec.respond(opid, ("OK", item))
        result = assert_linearizable(rec, specs.SpscRingSpec(2),
                                     "spsc_scalar")
        accepted = [o.args[0] for o in result.ops
                    if o.op == "send" and o.result == "OK"]
        delivered = [o.result[1] for o in result.ops
                     if o.op == "recv" and o.result[0] == "OK"]
        assert delivered == accepted, (delivered, accepted)

    world.tasks = [("p", producer), ("c", consumer)]
    world.fingerprint = lambda: (ring_fp(ring), rec.fingerprint())
    world.check = check
    return world


@_register("spsc_burst", "pass", "HostNBB", explore_budget=6000)
def spsc_burst() -> il.World:
    """Packet mode: span reservations racing span drains on a 3-slot
    ring (wrap-around covered: the second burst wraps)."""
    ring = HostNBB(3)
    rec = Recorder()
    world = il.World(tasks=[], fingerprint=None, check=None)

    def producer() -> None:
        for vals in ((0, 1), (2, 3)):
            opid = rec.invoke("p", "send_burst", vals)
            st, m = ring.send_burst(list(vals))
            rec.respond(opid, (specs.status_class(st), m))

    def consumer() -> None:
        for _ in range(3):
            opid = rec.invoke("c", "drain", 2)
            rec.respond(opid, tuple(ring.drain_burst(2)))

    def check() -> None:
        detectors.assert_no_torn_reads(world.trace, "spsc_burst")
        leftover = ring.drain_burst()
        if True:
            opid = rec.invoke("main", "drain", None)
            rec.respond(opid, tuple(leftover))
        result = assert_linearizable(rec, specs.SpscRingSpec(3),
                                     "spsc_burst")
        accepted = []
        for o in result.ops:
            if o.op == "send_burst":
                accepted.extend(o.args[0][:o.result[1]])
        delivered = [v for o in result.ops if o.op == "drain"
                     for v in o.result]
        assert delivered == accepted, (delivered, accepted)

    world.tasks = [("p", producer), ("c", consumer)]
    world.fingerprint = lambda: (ring_fp(ring), rec.fingerprint())
    world.check = check
    return world


# ---------------------------------------------------------------------------
# MPSC fan-in.
# ---------------------------------------------------------------------------
@_register("mpsc_fanin", "pass", "MpscQueue", explore_budget=12000)
def mpsc_fanin() -> il.World:
    """2 producers x 2 sends into private rings, consumer round-robin
    scan x 5 bounded polls — the issue's canonical small bound."""
    q = MpscQueue(2, capacity_per_producer=2)
    rec = Recorder()
    world = il.World(tasks=[], fingerprint=None, check=None)

    def producer(pid: int) -> Callable[[], None]:
        def fn() -> None:
            for k in range(2):
                item = 10 * pid + k
                opid = rec.invoke(f"p{pid}", "send", pid, item)
                rec.respond(opid,
                            specs.status_class(q.insert_item(pid, item)))
        return fn

    def consumer() -> None:
        for _ in range(5):
            opid = rec.invoke("c", "recv")
            st, got = q.read_item()
            rec.respond(opid, (specs.status_class(st), got))

    def check() -> None:
        detectors.assert_no_torn_reads(world.trace, "mpsc_fanin")
        while True:
            st, got = q.read_item()
            if st != nbb.OK:
                break
            opid = rec.invoke("main", "recv")
            rec.respond(opid, ("OK", got))
        result = assert_linearizable(rec, specs.MpscSpec(2, 2),
                                     "mpsc_fanin")
        delivered = [o.result[1] for o in result.ops
                     if o.op == "recv" and o.result[0] == "OK"]
        assert sorted(delivered) == [0, 1, 10, 11], delivered

    world.tasks = [("p0", producer(0)), ("p1", producer(1)),
                   ("c", consumer)]
    world.fingerprint = lambda: (mpsc_fp(q), rec.fingerprint())
    world.check = check
    return world


# ---------------------------------------------------------------------------
# Allocators: bitset and refcount array.
# ---------------------------------------------------------------------------
@_register("bitset_hammer", "pass", "HostBitset")
def bitset_hammer() -> il.World:
    """3 claimers hammer 2 slots: every slot claimed at most once, the
    loser's None refusal admitted weakly (scan allocator)."""
    bs = HostBitset(2)
    rec = Recorder()
    world = il.World(tasks=[], fingerprint=None, check=None)

    def claimer(name: str) -> Callable[[], None]:
        def fn() -> None:
            opid = rec.invoke(name, "try_claim")
            rec.respond(opid, bs.try_claim(owner=name))
        return fn

    def check() -> None:
        result = assert_linearizable(rec, specs.BitsetSpec(2),
                                     "bitset_hammer")
        wins = [o.result for o in result.ops if o.result is not None]
        assert len(wins) == len(set(wins)), wins     # distinct slots
        assert bs.count() == len(wins), (bs.count(), wins)

    world.tasks = [("a", claimer("a")), ("b", claimer("b")),
                   ("d", claimer("d"))]
    world.fingerprint = lambda: (bitset_fp(bs), rec.fingerprint())
    world.check = check
    return world


@_register("refcount_claim", "pass", "RefCountArray")
def refcount_claim() -> il.World:
    """3 claimers race claim-from-zero on 2 slots — the guard must
    yield at most one winner per slot."""
    rc = RefCountArray(2)
    rec = Recorder()
    world = il.World(tasks=[], fingerprint=None, check=None)

    def claimer(name: str) -> Callable[[], None]:
        def fn() -> None:
            opid = rec.invoke(name, "try_claim")
            rec.respond(opid, rc.try_claim())
        return fn

    def check() -> None:
        result = assert_linearizable(rec, specs.RefCountSpec(2),
                                     "refcount_claim")
        wins = [o.result for o in result.ops if o.result is not None]
        assert len(wins) == len(set(wins)), wins
        assert rc.count() == len(wins)
        for i in range(2):
            assert rc.refcount(i) <= 1, rc.refcount(i)

    world.tasks = [("a", claimer("a")), ("b", claimer("b")),
                   ("d", claimer("d"))]
    world.fingerprint = lambda: (refcount_fp(rc), rec.fingerprint())
    world.check = check
    return world


@_register("refcount_share", "pass", "RefCountArray")
def refcount_share() -> il.World:
    """incref/decref churn on a held slot racing a thief's
    claim-from-zero: the count never passes through zero, so the thief
    must never win (the storm test, deterministically)."""
    rc = RefCountArray(1)
    assert rc.try_claim() == 0                    # disarmed setup: held
    rec = Recorder()
    world = il.World(tasks=[], fingerprint=None, check=None)

    def churner(name: str) -> Callable[[], None]:
        def fn() -> None:
            for _ in range(2):
                opid = rec.invoke(name, "incref", 0)
                rc.incref(0)
                rec.respond(opid, MISSING)
                opid = rec.invoke(name, "decref", 0)
                rc.decref(0)
                rec.respond(opid, MISSING)
        return fn

    def thief() -> None:
        for _ in range(2):
            opid = rec.invoke("t", "claim_specific", 0)
            rec.respond(opid, rc.claim_specific(0))

    def check() -> None:
        ops = rec.ops()
        stolen = [o for o in ops
                  if o.op == "claim_specific" and o.result is True]
        assert not stolen, "claim-from-zero won while slot was held"
        assert rc.refcount(0) == 1, rc.refcount(0)

    world.tasks = [("x", churner("x")), ("y", churner("y")), ("t", thief)]
    world.fingerprint = lambda: (refcount_fp(rc), rec.fingerprint())
    world.check = check
    return world


# ---------------------------------------------------------------------------
# StateCell CAS consensus + compaction.
# ---------------------------------------------------------------------------
def _prefill(cell, n_ops: int) -> None:
    """Disarmed setup: walk REQUEST cycles to grow the journal."""
    edges = [(states.REQUEST_FREE, states.REQUEST_VALID),
             (states.REQUEST_VALID, states.REQUEST_RECEIVED),
             (states.REQUEST_RECEIVED, states.REQUEST_COMPLETED),
             (states.REQUEST_COMPLETED, states.REQUEST_FREE)]
    for k in range(n_ops):
        e, n = edges[k % 4]
        assert cell.cas(e, n)


@_register("statecell_cas", "pass", "StateCell")
def statecell_cas() -> il.World:
    """The OP_TRANSITIONS consensus: complete vs cancel racing through
    one CAS — exactly one terminal wins."""
    cell = states.op_cell("race")
    rec = Recorder()
    world = il.World(tasks=[], fingerprint=None, check=None)

    def proposer(name: str, new: str) -> Callable[[], None]:
        def fn() -> None:
            opid = rec.invoke(name, "cas", states.OP_PENDING, new)
            rec.respond(opid, cell.cas(states.OP_PENDING, new))
        return fn

    def check() -> None:
        opid = rec.invoke("main", "read")
        rec.respond(opid, cell.state)
        result = assert_linearizable(
            rec, specs.FsmSpec(states.OP_TRANSITIONS, states.OP_PENDING),
            "statecell_cas")
        wins = [o for o in result.ops if o.op == "cas" and o.result]
        assert len(wins) == 1, result.explain()

    world.tasks = [("done", proposer("done", states.OP_COMPLETED)),
                   ("kill", proposer("kill", states.OP_CANCELLED))]
    world.fingerprint = lambda: (cell_fp(cell), rec.fingerprint())
    world.check = check
    return world


@_register("statecell_compaction", "pass", "StateCell",
           explore_budget=20000, max_steps=600)
def statecell_compaction() -> il.World:
    """Two dependent CAS chains racing a journal compaction at the
    threshold — the exact window where the legacy cell lost updates.
    The resolved-prefix protocol must keep every reported win."""
    cell = states.StateCell(states.REQUEST_TRANSITIONS,
                            states.REQUEST_FREE, "compact", compact_at=4)
    _prefill(cell, 4)                 # journal at threshold, state FREE
    rec = Recorder()
    world = il.World(tasks=[], fingerprint=None, check=None)

    def proposer(name: str, edge: Tuple[str, str]) -> Callable[[], None]:
        def fn() -> None:
            opid = rec.invoke(name, "cas", *edge)
            rec.respond(opid, cell.cas(*edge))
        return fn

    def check() -> None:
        opid = rec.invoke("main", "read")
        rec.respond(opid, cell.state)
        assert_linearizable(
            rec, specs.FsmSpec(states.REQUEST_TRANSITIONS,
                               states.REQUEST_FREE),
            "statecell_compaction")

    world.tasks = [
        ("a", proposer("a", (states.REQUEST_FREE, states.REQUEST_VALID))),
        ("b", proposer("b", (states.REQUEST_VALID,
                             states.REQUEST_RECEIVED))),
    ]
    world.fingerprint = lambda: (cell_fp(cell), rec.fingerprint())
    world.check = check
    return world


class LegacyStateCell:
    """The original StateCell compaction algorithm, preserved verbatim
    (modulo explicit yield points) as the checker's found-bug exhibit:
    ``cas`` folds the journal and then replaces base and journal with
    TWO attribute stores — a competitor's winning proposal appended
    between the fold and the journal replacement is erased, so the cell
    regresses past a reported win.  ``repro_torch.core.states.StateCell``
    fixes this with the resolved-prefix single-store protocol."""

    def __init__(self, table, initial: str, compact_at: int = 4):
        self._table = table
        self._base = initial
        self._journal: list = []
        self._compact_at = compact_at

    def _fold(self):
        state = self._base
        winners = set()
        for seq, expected, new in self._journal:
            if expected == state and new in self._table[state]:
                state = new
                winners.add(seq)
        return state, winners

    @property
    def state(self) -> str:
        return self._fold()[0]

    def cas(self, expected: str, new: str) -> bool:
        if new not in self._table.get(expected, frozenset()):
            raise states.IllegalTransition(f"{expected} -> {new}")
        seq = next(states._seq)
        il.yield_point("legacy.append", id(self))
        self._journal.append((seq, expected, new))
        il.yield_point("legacy.fold", id(self))
        _, winners = self._fold()
        won = seq in winners
        if len(self._journal) > self._compact_at:
            state, _ = self._fold()
            il.yield_point("legacy.swap.base", id(self))
            self._base = state            # two stores: the fatal window
            il.yield_point("legacy.swap.journal", id(self))
            self._journal = []
        return won


@_register("legacy_statecell_compaction", "violation", "StateCell",
           explore_budget=20000, max_steps=600)
def legacy_statecell_compaction() -> il.World:
    """The counterexample scenario: same cast as ``statecell_compaction``
    against the legacy algorithm.  ``explore`` finds a schedule where a
    reported win evaporates; the minimized schedule is committed under
    ``tests/schedules/`` as a regression."""
    cell = LegacyStateCell(states.REQUEST_TRANSITIONS,
                           states.REQUEST_FREE, compact_at=4)
    edges = [(states.REQUEST_FREE, states.REQUEST_VALID),
             (states.REQUEST_VALID, states.REQUEST_RECEIVED),
             (states.REQUEST_RECEIVED, states.REQUEST_COMPLETED),
             (states.REQUEST_COMPLETED, states.REQUEST_FREE)]
    for k in range(4):                # journal at threshold, state FREE
        assert cell.cas(*edges[k])
    rec = Recorder()
    world = il.World(tasks=[], fingerprint=None, check=None)

    def proposer(name: str, edge: Tuple[str, str]) -> Callable[[], None]:
        def fn() -> None:
            opid = rec.invoke(name, "cas", *edge)
            rec.respond(opid, cell.cas(*edge))
        return fn

    def check() -> None:
        opid = rec.invoke("main", "read")
        rec.respond(opid, cell.state)
        assert_linearizable(
            rec, specs.FsmSpec(states.REQUEST_TRANSITIONS,
                               states.REQUEST_FREE),
            "legacy_statecell_compaction")

    world.tasks = [
        ("a", proposer("a", (states.REQUEST_FREE, states.REQUEST_VALID))),
        ("b", proposer("b", (states.REQUEST_VALID,
                             states.REQUEST_RECEIVED))),
    ]
    world.fingerprint = lambda: (
        (cell._base, tuple(cell._journal)), rec.fingerprint())
    world.check = check
    return world


# ---------------------------------------------------------------------------
# OpHandle: exactly one terminal state.
# ---------------------------------------------------------------------------
@_register("ophandle_cancel", "pass", "OpHandle", max_steps=600)
def ophandle_cancel() -> il.World:
    """test() racing cancel() on a recv handle over a 1-item ring: the
    PENDING -> COMPLETED|CANCELLED CAS admits exactly one terminal, and
    a committed queue op that loses to cancel parks its item in
    ``late_result`` instead of losing it."""
    ring = HostNBB(2)
    assert ring.insert_item(77) == nbb.OK         # disarmed preload
    h = transport.OpHandle(ring.read_item, name="recv")
    results: Dict[str, object] = {}
    world = il.World(tasks=[], fingerprint=None, check=None)

    def tester() -> None:
        results["test"] = h.test()

    def canceller() -> None:
        results["cancel"] = h.cancel()

    def check() -> None:
        assert h.done
        assert h.completed != h.cancelled          # exactly one terminal
        if h.completed:
            assert results.get("test") is True
            assert results.get("cancel") is False
            assert h.result == 77 and len(ring) == 0
        else:
            assert results.get("cancel") is True
            assert results.get("test") in (False, None)
            if h.attempted_ok:                     # op landed, cancel won
                assert h.late_result == 77         # parked, not lost
                assert len(ring) == 0
            else:
                assert len(ring) == 1              # item untouched

    world.tasks = [("test", tester), ("cancel", canceller)]
    world.fingerprint = lambda: (
        ring_fp(ring), cell_fp(h._fsm),
        tuple(sorted(results.items())), h.attempted_ok)
    world.check = check
    return world


# ---------------------------------------------------------------------------
# PriorityTransport scan order.
# ---------------------------------------------------------------------------
@_register("priority_scan", "pass", "PriorityTransport",
           explore_budget=8000)
def priority_scan() -> il.World:
    """Preloaded urgent (class 0) and bulk (class 1) items with a
    producer topping up class 0 mid-scan: per-class FIFO holds
    (linearizability) and a preloaded bulk item is never delivered
    before the preloaded urgent one (the scan's priority guarantee for
    items committed before the scan began)."""
    pt = transport.PriorityTransport([HostNBB(2), HostNBB(2)])
    rec = Recorder()
    # Disarmed preload, recorded so the spec sees it.
    for cls, item in ((0, "a0"), (1, "b0")):
        opid = rec.invoke("setup", "send", cls, item)
        rec.respond(opid, specs.status_class(pt.send_to(item, cls)))
    world = il.World(tasks=[], fingerprint=None, check=None)

    def producer() -> None:
        opid = rec.invoke("p", "send", 0, "a1")
        rec.respond(opid, specs.status_class(pt.send_to("a1", 0)))

    def consumer() -> None:
        for _ in range(3):
            opid = rec.invoke("c", "recv")
            st, got = pt.try_recv()
            rec.respond(opid, (specs.status_class(st), got))

    def check() -> None:
        detectors.assert_no_torn_reads(world.trace, "priority_scan")
        for item in pt.drain():
            opid = rec.invoke("main", "recv")
            rec.respond(opid, ("OK", item))
        result = assert_linearizable(rec, specs.PriorityFanSpec(2, 2),
                                     "priority_scan")
        delivered = [o.result[1] for o in result.ops
                     if o.op == "recv" and o.result[0] == "OK"]
        assert sorted(delivered) == ["a0", "a1", "b0"], delivered
        assert delivered.index("a0") < delivered.index("b0"), delivered

    world.tasks = [("p", producer), ("c", consumer)]
    world.fingerprint = lambda: (
        tuple(ring_fp(r) for r in pt.classes), rec.fingerprint())
    world.check = check
    return world


# ---------------------------------------------------------------------------
# Fault composition: torn-span recovery model-checked (PR-8 paths).
# ---------------------------------------------------------------------------
@_register("torn_span_recovery", "pass", "HostNBB+FaultPlan",
           explore_budget=30000, max_steps=600)
def torn_span_recovery() -> il.World:
    """A producer dies mid-span-reservation (``transport.stall`` via
    FaultPlan) at every reachable interleaving point; a consumer drains
    concurrently; a recovery task rolls the ring back (``recover_ring``)
    once the producer is known dead and resumes service.  Invariants:
    the consumer only ever sees the committed prefix — never a slot of
    the stalled span — and post-recovery sends are delivered."""
    ring = HostNBB(4)
    plan = faults.FaultPlan(
        [faults.FaultRule(site="transport.stall", nth=2)], name="stall")
    ft = transport.FaultyTransport(ring, plan, name="spsc")
    rec = Recorder()
    flags: Dict[str, bool] = {"dead": False, "recovered": False,
                              "resent": False}
    world = il.World(tasks=[], fingerprint=None, check=None)

    def producer() -> None:
        opid = rec.invoke("p", "send_burst", (0, 1))
        st, m = ft.send_burst([0, 1])             # commits: the prefix
        rec.respond(opid, (specs.status_class(st), m))
        opid = rec.invoke("p", "send_burst", (2, 3))
        try:
            ft.send_burst([2, 3])                 # stalls: announced, dead
        except faults.InjectedFault:
            flags["dead"] = True
            rec.respond(opid, MISSING)

    def consumer() -> None:
        for _ in range(4):
            opid = rec.invoke("c", "recv")
            st, got = ring.read_item()
            rec.respond(opid, (specs.status_class(st), got))

    def reaper() -> None:
        for _ in range(4):
            il.yield_point("reaper.poll", None)
            if flags["dead"]:
                flags["recovered"] = faults.recover_ring(ring)
                il.yield_point("reaper.resend", None)
                st = ring.insert_item(9)          # new producer-owner
                flags["resent"] = st == nbb.OK
                return

    def check() -> None:
        detectors.assert_no_torn_reads(world.trace, "torn_span_recovery")
        delivered = [o.result[1] for o in rec.ops()
                     if o.op == "recv" and o.result is not MISSING
                     and o.result[0] == "OK"]
        delivered += ring.drain()                  # disarmed completeness
        # Committed-prefix-only delivery: the stalled span (2, 3) must
        # never surface, whole committed prefix must, in order.
        assert not any(v in (2, 3) for v in delivered), delivered
        expect = [0, 1] + ([9] if flags["resent"] else [])
        assert delivered == expect, (delivered, flags)
        if flags["dead"] and flags["recovered"]:
            assert not ring._uc & 1                # rollback landed

    world.tasks = [("p", producer), ("c", consumer), ("r", reaper)]
    world.fingerprint = lambda: (
        ring_fp(ring), rec.fingerprint(), tuple(sorted(flags.items())))
    world.check = check
    return world


@_register("mpsc_dead_producer", "pass", "MpscQueue+FaultPlan",
           explore_budget=20000, max_steps=600)
def mpsc_dead_producer() -> il.World:
    """One producer of an MPSC fan-in dies mid-span; siblings and the
    round-robin consumer must be unaffected (the stalled ring's span is
    invisible, other rings drain normally)."""
    q = MpscQueue(2, capacity_per_producer=4)
    rec = Recorder()
    world = il.World(tasks=[], fingerprint=None, check=None)

    def dying_producer() -> None:
        opid = rec.invoke("p0", "send", 0, 100)
        rec.respond(opid, specs.status_class(q.insert_item(0, 100)))
        il.yield_point("p0.stall", None)
        faults.stall_mid_burst(q.producer(0), [101, 102])  # dies here

    def live_producer() -> None:
        for item in (200, 201):
            opid = rec.invoke("p1", "send", 1, item)
            rec.respond(opid, specs.status_class(q.insert_item(1, item)))

    def consumer() -> None:
        for _ in range(4):
            opid = rec.invoke("c", "recv")
            st, got = q.read_item()
            rec.respond(opid, (specs.status_class(st), got))

    def check() -> None:
        detectors.assert_no_torn_reads(world.trace, "mpsc_dead_producer")
        delivered = [o.result[1] for o in rec.ops()
                     if o.op == "recv" and o.result[0] == "OK"]
        delivered += q.drain_burst()
        assert not any(v in (101, 102) for v in delivered), delivered
        assert [v for v in delivered if v >= 200] == [200, 201], delivered
        assert 100 in delivered, delivered

    world.tasks = [("p0", dying_producer), ("p1", live_producer),
                   ("c", consumer)]
    world.fingerprint = lambda: (mpsc_fp(q), rec.fingerprint())
    world.check = check
    return world


# ---------------------------------------------------------------------------
# Detector sensitivity: a deliberately broken ring must be convicted.
# ---------------------------------------------------------------------------
class BrokenNBB(HostNBB):
    """HostNBB with the commit store hoisted ABOVE the slot write — the
    textbook epoch-protocol bug.  A consumer scheduled between commit
    and write reads a slot the producer is still writing."""

    def insert_item(self, item) -> int:           # type: ignore[override]
        il.yield_point("nbb.send.load", id(self))
        uc = self._uc
        ac = self._ac
        if (uc // 2) - (ac // 2) >= self._n:
            return nbb.BUFFER_FULL_BUT_CONSUMER_READING if ac & 1 \
                else nbb.BUFFER_FULL
        il.yield_point("nbb.send.commit", id(self))
        self._uc = uc + 2                         # BUG: commit first ...
        il.yield_point("nbb.send.slot", (id(self), (uc // 2) % self._n))
        self._slots[(uc // 2) % self._n] = item   # ... write after
        return nbb.OK


@_register("broken_ring", "violation", "detector-sensitivity")
def broken_ring() -> il.World:
    """The torn-read detector must convict the commit-before-write ring
    (a schedule exists where the consumer reads the unwritten slot)."""
    ring = BrokenNBB(2)
    rec = Recorder()
    world = il.World(tasks=[], fingerprint=None, check=None)

    def producer() -> None:
        for item in (5, 6):
            opid = rec.invoke("p", "send", item)
            rec.respond(opid, specs.status_class(ring.insert_item(item)))

    def consumer() -> None:
        for _ in range(3):
            opid = rec.invoke("c", "recv")
            st, got = ring.read_item()
            rec.respond(opid, (specs.status_class(st), got))

    def check() -> None:
        detectors.assert_no_torn_reads(world.trace, "broken_ring")

    world.tasks = [("p", producer), ("c", consumer)]
    world.fingerprint = lambda: (ring_fp(ring), rec.fingerprint())
    world.check = check
    return world


# ---------------------------------------------------------------------------
# Convenience drivers.
# ---------------------------------------------------------------------------
def explore_scenario(name: str,
                     max_executions: Optional[int] = None,
                     max_steps: Optional[int] = None) -> il.ExploreResult:
    s = get(name)
    return il.explore(
        s.make_world,
        max_executions=max_executions or s.explore_budget,
        max_steps=max_steps or s.max_steps)


def fuzz_scenario(name: str, seed: int = 0, runs: int = 50,
                  max_steps: Optional[int] = None) -> il.FuzzResult:
    s = get(name)
    return il.fuzz(s.make_world, seed=seed, runs=runs,
                   max_steps=max_steps or s.max_steps)


def replay(name: str, schedule, strict: bool = False) -> il.RunResult:
    s = get(name)
    return il.run_schedule(s.make_world, schedule,
                           max_steps=s.max_steps, strict=strict)
