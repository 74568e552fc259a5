"""Overload-control subsystem: priority classes, WFQ intake, SLO shed.

The paper's QPN model exists as a *stop criterion*: lock-free exchange
is only worth validating if the system still meets latency guarantees
when intake exceeds capacity.  This module is the engine's answer to
"what happens past saturation", built from the same
lock-free parts as the data plane:

  * :class:`OverloadPolicy` — the engine's QoS knobs, passed to
    ``ServeEngine(overload=...)``.  ``None`` keeps the legacy FIFO
    intake byte-for-byte.
  * :class:`PriorityIntake` — the multi-class intake fan-in: one
    :class:`~repro_torch.core.host_queue.MpscQueue` per priority class (so
    every (class, client) pair owns a private SPSC NBB ring and the
    whole structure stays lock-free end to end), drained by
    STRICT-PRIORITY-WITH-AGING: class 0 first, but a nonempty class
    bypassed ``aging_limit`` times is served next and its popped
    request is promoted (preemption immunity) — sustained high-priority
    floods cannot starve lower classes.
  * WEIGHTED FAIR QUEUING within a class: the consumer picks, among the
    nonempty per-client rings, the client with the least virtual time;
    ``charge(client, cost)`` advances a client's virtual time by
    ``cost / weight`` when the engine binds its request (cost = the KV
    footprint, bucketed prompt + generation budget).  One flooding
    client therefore shares capacity by weight instead of winning every
    round-robin slot its burst occupies.
  * :class:`ShedStatus` — typed falsy terminal status (like
    ``OversizeStatus``) for SLO-aware admission: a request whose
    deadline already passed when the batcher pops it is shed at intake
    — early, before it claims pages or a slot — instead of convoying
    the queue, which is precisely the lock-based failure mode the paper
    measures.

Preemption itself (the BUFFER_PREEMPTED page-swap path) lives in the
engine + :class:`~repro_torch.serve.kv_cache.PagedKVPool`; this module only
decides *who goes first*.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

from repro_torch.core import nbb
from repro_torch.core.host_queue import MpscQueue

# Priority classes (0 = most urgent, matching the MESSAGE channels'
# MCAPI convention).  The engine accepts any class in
# [0, OverloadPolicy.n_classes); these three name the default tiers.
PRIORITY_HIGH = 0
PRIORITY_NORMAL = 1
PRIORITY_LOW = 2


@dataclasses.dataclass(frozen=True)
class OverloadPolicy:
    """QoS policy for :class:`~repro_torch.serve.engine.ServeEngine`.

    ``priorities``  — multi-class intake (strict priority with aging).
    ``preemption``  — page-swap preemption of lower-class decoding
                      sequences under slot/pool pressure (slot_paged
                      only: pages ARE the KV store there, so swapping
                      them captures the whole sequence state).
    ``wfq``         — weighted fair queuing across clients within a
                      class (per-client virtual time over the MPSC
                      ring's per-producer spans).
    ``aging_limit`` — pops a nonempty class (or a parked sequence) may
                      be bypassed by more urgent work before it is
                      served next with promotion.
    ``slo_s``       — default TTFT deadline; a request older than this
                      at pop time is shed (``ShedStatus``).  None (and
                      per-request ``slo_s=None``) disables shedding.
    ``weights``     — per-client WFQ weights (missing clients get 1.0).
    """

    priorities: bool = True
    preemption: bool = True
    wfq: bool = True
    n_classes: int = 3
    aging_limit: int = 8
    slo_s: Optional[float] = None
    weights: Optional[Tuple[float, ...]] = None

    def __post_init__(self):
        if self.n_classes < 1:
            raise ValueError("need n_classes >= 1")
        if self.aging_limit < 1:
            raise ValueError("need aging_limit >= 1")


@dataclasses.dataclass(frozen=True)
class ShedStatus:
    """Typed SLO shed from admission: the request waited past its
    deadline before the batcher could pop it, so it was refused at
    intake — no pages claimed, no slot bound, no device work.  Falsy,
    like ``TimeoutStatus``/``OversizeStatus``, and delivered on the
    terminal Request (``handle.status``)."""

    waited_s: float
    slo_s: float
    priority: int

    def __bool__(self) -> bool:
        return False


class PriorityIntake:
    """Multi-class, weighted-fair intake fan-in for the serve engine.

    Structure: ``n_classes`` MpscQueues, each with one private SPSC
    ring per client — every ring keeps the single-writer invariant, so
    the composition is lock-free exactly like the flat MpscQueue it
    replaces.  All consumer-side state (bypass counters, virtual
    times) is owned by the single batcher thread; producers only ever
    touch their own rings.

    Drain order (``pop``):
      1. classes strict-priority (lowest number first), except that a
         nonempty class bypassed ``aging_limit`` consecutive times is
         served next (``promoted=True`` — the engine boosts the popped
         request's effective class so it cannot be instantly
         preempted, closing the livelock);
      2. within a class, WFQ: the nonempty client ring with the least
         virtual time (ties to the lowest client id); round-robin when
         WFQ is off.
    """

    def __init__(self, n_clients: int, policy: OverloadPolicy,
                 capacity_per_producer: int = 64):
        self.policy = policy
        self.n_clients = n_clients
        self.n_classes = policy.n_classes if policy.priorities else 1
        self._queues = [MpscQueue(n_clients, capacity_per_producer)
                        for _ in range(self.n_classes)]
        self._bypassed = [0] * self.n_classes
        self._vtime = [0.0] * n_clients
        w = policy.weights or ()
        self._weights = [float(w[i]) if i < len(w) and w[i] > 0 else 1.0
                         for i in range(n_clients)]

    def clamp(self, priority: int) -> int:
        return max(0, min(self.n_classes - 1, int(priority)))

    def producer(self, client_id: int, priority: int = PRIORITY_NORMAL):
        """The private SPSC ring for (client, class) — single-writer,
        so submission stays a plain Transport ``send``."""
        return self._queues[self.clamp(priority)].producer(client_id)

    # -- consumer side (batcher thread only) --------------------------------
    def _pending(self, cls: int) -> bool:
        return self._queues[cls].pending()

    def highest_pending_class(self) -> Optional[int]:
        """Most urgent class with a committed request right now, or
        None.  Consumer-side probe: concurrent inserts can only make
        the answer conservatively stale (miss brand-new work), never
        invent work."""
        for c in range(self.n_classes):
            if self._pending(c):
                return c
        return None

    def _recv_class(self, cls: int) -> Tuple[int, Optional[Any]]:
        q = self._queues[cls]
        if self.policy.wfq:
            best = None
            for i in range(self.n_clients):
                if len(q.producer(i)) and (
                        best is None
                        or self._vtime[i] < self._vtime[best]):
                    best = i
            if best is not None:
                return q.producer(best).read_item()
        return q.try_recv()

    def pop(self) -> Tuple[int, Optional[Any], bool]:
        """One admission pop: ``(status, item, promoted)``.

        ``promoted`` is True when aging served a class over a more
        urgent nonempty one — the caller should boost the item's
        effective priority so the promotion sticks."""
        pending = [c for c in range(self.n_classes) if self._pending(c)]
        if not pending:
            return nbb.BUFFER_EMPTY, None, False
        pick, promoted = pending[0], False
        for c in pending[1:]:
            if self._bypassed[c] >= self.policy.aging_limit:
                pick, promoted = c, True
                break
        for c in pending:
            if c != pick:
                self._bypassed[c] += 1
        self._bypassed[pick] = 0
        status, item = self._recv_class(pick)
        if status != nbb.OK:
            return status, None, False
        return nbb.OK, item, promoted

    def try_recv(self) -> Tuple[int, Optional[Any]]:
        """Transport-shaped pop (promotion flag dropped) so schedulers
        written against the flat MpscQueue keep working."""
        status, item, _ = self.pop()
        return status, item

    def charge(self, client_id: int, cost: float) -> None:
        """Advance a client's WFQ virtual time by ``cost / weight``.
        Called by the engine when it BINDS the client's request (cost =
        the request's KV footprint), not at pop — shed/cancelled
        requests consume no capacity, so they cost nothing."""
        if self.policy.wfq:
            self._vtime[client_id] += cost / self._weights[client_id]

    def vtimes(self) -> List[float]:
        """Snapshot of per-client virtual times (stats/tests)."""
        return list(self._vtime)
