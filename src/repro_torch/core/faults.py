"""Deterministic fault injection: seeded, schedule-addressable plans.

The paper's position is that removing locks is only acceptable once the
system's properties are *validated* — and partial failure is the
property lock-free designs are hardest on (a died producer cannot be
"unlocked" by anyone; the protocol itself must make its half-finished
operation harmless).  This module provokes those failures on purpose:

  * A :class:`FaultPlan` is a list of :class:`FaultRule`\\ s, each
    addressing an injection SITE by name (exact or fnmatch pattern) and
    a schedule ("fail the ``nth`` matching probe, for ``times``
    consecutive probes").  Sites are threaded through the transport
    layer (:class:`repro_torch.core.transport.FaultyTransport`), the page pool
    (``serve/kv_cache.py``) and the serve engine (``serve/engine.py``);
    each calls ``plan.fire(site)`` at its probe point and acts on the
    returned action — or does nothing when no plan is armed, so the
    zero-fault fast path costs one ``is None`` check.
  * Plans are pure host-side counters: given the same single-threaded
    probe sequence, the same plan fires at the same operations — which
    is what lets the fault sweep assert byte-identical survivor tokens
    against a no-fault run (benchmarks/bench_faults.py).
  * ``stall_mid_burst`` / ``recover_ring`` model the one failure a
    refusal cannot: a producer dying BETWEEN the announce and the commit
    of an NBB span reservation.  The ring is left with an odd update
    counter — consumers correctly see only the committed prefix (the
    Table-1 transient status, never a torn span) — and recovery is a
    single producer-side counter rollback, legal exactly when the
    producer is known dead (the engine's lease contract, DESIGN.md §13).

Default action per site (a rule with ``action=None`` uses it):

  refuse   — the probe's caller returns its Table-1/POOL_FULL refusal
             status; the operation simply did not happen (every refusal
             site is a path the system already handles under pressure).
  raise    — the probe raises :class:`InjectedFault` (retryable: the
             engine's tick watchdog may retry the tick).
  stall    — producer dies mid-span-reservation (transports only).
  poison   — a page write is declared corrupted; the engine quarantines
             the implicated pages and fails the slot.
  timeout  — a device sync that never returns; raised as a
             non-retryable :class:`InjectedFault` (the device state is
             past the point a retry could reconcile).
"""
from __future__ import annotations

import dataclasses
import fnmatch
import random
from contextlib import contextmanager
from typing import List, Optional, Sequence

ACT_REFUSE = "refuse"
ACT_RAISE = "raise"
ACT_STALL = "stall"
ACT_POISON = "poison"
ACT_TIMEOUT = "timeout"

#: Site catalog: every probe point in the system and its default action.
SITES = {
    "transport.send": ACT_REFUSE,        # response-ring scalar insert
    "transport.recv": ACT_REFUSE,        # intake pop / client drain
    "transport.send_burst": ACT_REFUSE,  # stream-ring span insert
    "transport.stall": ACT_STALL,        # producer dies mid-reservation
    "pool.claim": ACT_REFUSE,            # admission page claim
    "pool.extend": ACT_REFUSE,           # chunked reservation growth
    "pool.cow": ACT_REFUSE,              # copy-on-write privatization
    "pool.swap_out": ACT_RAISE,          # preemption gather (pre-mutation)
    "pool.swap_in": ACT_REFUSE,          # resume re-claim
    "pool.page_write": ACT_POISON,       # KV write declared corrupted
    "engine.dispatch": ACT_RAISE,        # jitted call refuses to launch
    "engine.sync": ACT_TIMEOUT,          # device->host fetch "hangs"
    "snapshot.write": ACT_REFUSE,        # process dies mid-snapshot (torn file)
    "snapshot.restore": ACT_REFUSE,      # restore aborts before mutation
    "journal.append": ACT_REFUSE,        # WAL record lost at BIND
}


class InjectedFault(RuntimeError):
    """Raised at a ``raise``/``stall``/``timeout`` site.  ``retryable``
    tells the tick watchdog whether re-running the tick from the top can
    reconcile (pre-dispatch host bookkeeping is idempotent) or the
    device already advanced past what the host harvested (it cannot)."""

    def __init__(self, site: str, seq: int = 0, retryable: bool = True):
        super().__init__(f"injected fault at {site} (fire #{seq})")
        self.site = site
        self.seq = seq
        self.retryable = retryable


@dataclasses.dataclass
class FaultRule:
    """Fire at probes ``nth .. nth+times-1`` of sites matching ``site``
    (exact name or fnmatch pattern, e.g. ``"pool.*"``).  ``action=None``
    uses the site's catalog default.  ``times`` is finite by default so
    every plan eventually goes quiet — the sweep's convergence
    guarantee."""

    site: str
    nth: int = 1
    times: int = 1
    action: Optional[str] = None


class FaultPlan:
    """A seeded, deterministic schedule of injected faults.

    ``probe(site)`` advances every matching rule's probe counter and
    returns the first rule inside its firing window (appending to the
    ``fired`` log), or None.  ``fire(site)`` resolves the rule to its
    action string.  ``pause()`` suspends firing (a context manager) so
    recovery code — the watchdog failing slots, the lease reaper — can
    use the same transports without recursing into fresh faults.

    Probe counters are plain ints under the GIL; the sweep harness
    drives engine and client from one thread, where the probe sequence
    (and therefore the fire schedule) is fully deterministic.
    """

    def __init__(self, rules: Sequence[FaultRule], name: str = ""):
        self.rules = list(rules)
        self.name = name
        self._counts = [0] * len(self.rules)
        self.fired: List[str] = []      # site name per fire, in order
        self._paused = 0

    def __repr__(self) -> str:
        return (f"FaultPlan({self.name or 'anon'}, "
                f"{len(self.rules)} rules, {self.n_fired} fired)")

    @property
    def n_fired(self) -> int:
        return len(self.fired)

    @contextmanager
    def pause(self):
        """Suspend firing while recovery code runs (re-entrant)."""
        self._paused += 1
        try:
            yield self
        finally:
            self._paused -= 1

    def probe(self, site: str) -> Optional[FaultRule]:
        if self._paused:
            return None
        hit = None
        for i, r in enumerate(self.rules):
            if r.site == site or fnmatch.fnmatchcase(site, r.site):
                self._counts[i] += 1
                if hit is None and r.nth <= self._counts[i] < r.nth + r.times:
                    hit = r
        if hit is not None:
            self.fired.append(site)
        return hit

    def fire(self, site: str) -> Optional[str]:
        """Probe; the action string when a rule fires, else None."""
        rule = self.probe(site)
        if rule is None:
            return None
        return rule.action or SITES.get(site, ACT_RAISE)

    @classmethod
    def random(cls, seed: int, n_rules: int = 3,
               sites: Optional[Sequence[str]] = None, max_nth: int = 6,
               max_times: int = 2, name: str = "") -> "FaultPlan":
        """A seeded random plan over ``sites`` (default: the catalog).
        Same seed, same rules — the schedule is reproducible."""
        rng = random.Random(seed)
        pool = list(sites) if sites is not None else list(SITES)
        rules = [FaultRule(site=rng.choice(pool),
                           nth=rng.randint(1, max_nth),
                           times=rng.randint(1, max_times))
                 for _ in range(n_rules)]
        return cls(rules, name=name or f"random-{seed}")

    @classmethod
    def sweep(cls, n_plans: int, seed: int = 0,
              sites: Optional[Sequence[str]] = None,
              extra_rules: int = 1) -> List["FaultPlan"]:
        """The fault-matrix sweep: plan ``i`` pins one early-firing rule
        to site ``i % len(sites)`` (round-robin, so every site class is
        targeted ~``n_plans/len(sites)`` times across the sweep) plus
        ``extra_rules`` random riders.  Pinned rules fire on the 1st or
        2nd matching probe — rare sites (swap, CoW) are probed only a
        handful of times per run, and a deep ``nth`` would silently turn
        their plans into no-ops."""
        pool = list(sites) if sites is not None else list(SITES)
        plans = []
        for i in range(n_plans):
            rng = random.Random(seed * 1000003 + i)
            pinned = FaultRule(site=pool[i % len(pool)],
                               nth=rng.randint(1, 2),
                               times=rng.randint(1, 2))
            riders = [FaultRule(site=rng.choice(pool),
                                nth=rng.randint(1, 6), times=1)
                      for _ in range(extra_rules)]
            plans.append(cls([pinned] + riders, name=f"sweep-{seed}-{i}"))
        return plans


# ---------------------------------------------------------------------------
# Producer-death helpers for NBB rings (HostNBB counter protocol).
# ---------------------------------------------------------------------------
def stall_mid_burst(ring, vals) -> int:
    """Simulate a producer dying mid-``send_burst``: announce the span
    (odd update counter), write some slots, never commit.  Consumers
    observe only the committed prefix — ``drain_burst`` computes
    availability from ``uc // 2``, which excludes the announced span,
    and ``read_item`` on the boundary reports the Table-1 transient
    status — so no torn or reordered span is ever visible.  Returns the
    span size that died (0 when the ring was full: the producer died
    before announcing, leaving the ring untouched)."""
    uc = ring._uc
    ac = ring._ac
    space = ring._n - ((uc // 2) - (ac // 2))
    m = min(space, len(vals))
    if m <= 0:
        return 0
    ring._uc = uc + 1                   # announce ... and die: no commit
    start = (uc // 2) % ring._n
    for j in range(m):
        ring._slots[(start + j) % ring._n] = vals[j]
    return m


def recover_ring(ring) -> bool:
    """Roll back a dead producer's announced-but-uncommitted span (the
    odd update counter): one counter store returns the ring to its last
    committed state, ready for a new producer.

    This writes the PRODUCER-owned counter, so it is legal only when the
    producer is known dead — the engine invokes it from the lease reaper
    (a client past its lease is presumed dead, DESIGN.md §13) and from
    the tick watchdog on its own rings (the engine thread IS the
    producer there).  True iff a span was rolled back."""
    uc = getattr(ring, "_uc", None)
    if uc is None or not uc & 1:
        return False
    ring._uc = uc - 1
    return True
