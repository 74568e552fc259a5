"""Host-side lock-free queues composed from NBBs.

The paper (via Kim'07) notes the NBB "can be composed to support complex
communication patterns including publish/subscribe and broadcast".  We
compose:

  * :class:`SpscQueue` — thin alias over :class:`repro_torch.core.nbb.HostNBB`.
  * :class:`MpscQueue` — N producers fan into one consumer via N private
    SPSC rings drained round-robin.  Each ring keeps the single-writer
    invariant, so the composition stays lock-free end to end (this is the
    MCAPI "multiple client endpoints -> one server receive queue" topology
    of the paper's Figure 1, without its global lock).
  * :class:`LockedQueue` — the *lock-based baseline* the paper measures
    against: a deque guarded by one mutex, standing in for the MCAPI
    reference implementation's global reader/writer lock.

All of them implement the unified Transport protocol
(``repro_torch.core.transport``): ``send`` / ``try_recv`` / ``drain`` with
Table-1 status codes, so channels and engines are written against one
surface regardless of which queue backs them.

Framework uses: the data pipeline feeds the trainer through an MpscQueue;
the serving engine's slot-swap batcher drains client SPSC rings; the async
checkpointer receives snapshots through an SPSC ring.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Any, List, Optional, Tuple

from repro_torch.core import interleave as _il
from repro_torch.core import nbb, transport
from repro_torch.core.nbb import HostNBB

SpscQueue = HostNBB


class MpscQueue:
    """Multi-producer single-consumer lock-free queue (fan-in of SPSC NBBs)."""

    def __init__(self, nproducers: int, capacity_per_producer: int = 64):
        self._rings: List[HostNBB] = [
            HostNBB(capacity_per_producer) for _ in range(nproducers)
        ]
        self._cursor = 0  # consumer-owned round-robin cursor

    def producer(self, i: int) -> HostNBB:
        """The private SPSC ring for producer ``i`` (single-writer)."""
        return self._rings[i]

    @property
    def n_producers(self) -> int:
        return len(self._rings)

    def pending(self) -> bool:
        """Consumer-side emptiness probe: True iff some producer ring
        holds a COMMITTED item right now.  Uses the rings' ``__len__``
        (uc//2 - ac//2 snapshot), which only counts committed inserts —
        safe for the single consumer to branch on (a concurrent insert
        can only turn False stale, never True)."""
        return any(len(r) for r in self._rings)

    def insert_item(self, producer_id: int, item: Any) -> int:
        return self._rings[producer_id].insert_item(item)

    def read_item(self) -> Tuple[int, Optional[Any]]:
        """Drain round-robin; returns first available item.  EMPTY only when
        every producer ring is empty this pass."""
        n = len(self._rings)
        busy = False
        for off in range(n):
            ring = self._rings[(self._cursor + off) % n]
            if _il._active is not None:
                _il._active.yield_point(
                    "mpsc.scan", (id(self), (self._cursor + off) % n))
            status, item = ring.read_item()
            if status == nbb.OK:
                self._cursor = (self._cursor + off + 1) % n
                return nbb.OK, item
            if status == nbb.BUFFER_EMPTY_BUT_PRODUCER_INSERTING:
                busy = True
        return (nbb.BUFFER_EMPTY_BUT_PRODUCER_INSERTING if busy
                else nbb.BUFFER_EMPTY), None

    # -- Transport protocol (consumer side) ----------------------------------
    # Producers are NOT funneled through a shared ``send`` — each producer
    # owns its private SPSC ring (``producer(i)``, itself a Transport),
    # which is what keeps the composition lock-free.
    try_recv = read_item

    def recv_i(self) -> transport.OpHandle:
        """Consumer-side non-blocking receive handle.  (No ``send_i``:
        producers hold their private rings, each a full Transport.)"""
        return transport.recv_i(self)

    def drain(self, max_items: Optional[int] = None) -> List[Any]:
        return transport.drain(self, max_items)

    def drain_burst(self, max_n: Optional[int] = None) -> List[Any]:
        """Packet-mode fan-in drain: one span reservation per producer
        ring, visited in round-robin order from the cursor.  Per-producer
        FIFO is preserved (each ring is drained as one contiguous span);
        global order is round-robin by ring, as for scalar reads."""
        out: List[Any] = []
        n = len(self._rings)
        for off in range(n):
            take = None if max_n is None else max_n - len(out)
            if take is not None and take <= 0:
                break
            if _il._active is not None:
                _il._active.yield_point(
                    "mpsc.burst.scan", (id(self), (self._cursor + off) % n))
            out.extend(self._rings[(self._cursor + off) % n]
                       .drain_burst(take))
        if n:
            self._cursor = (self._cursor + 1) % n
        return out

    def get(self) -> Any:
        status, item = transport.recv_blocking(self)
        assert status == nbb.OK
        return item


class BroadcastChannel:
    """One producer -> N consumers, each with a private SPSC ring.

    Kim'07's composition claim (quoted in the paper §2): the NBB "can be
    composed to support complex communication patterns including
    publish/subscribe and broadcast connections".  Every consumer gets
    every item; the producer's insert is non-blocking per ring and
    reports the per-consumer status vector (a slow consumer only stalls
    itself — slot disjointness holds per ring).
    """

    def __init__(self, nconsumers: int, capacity: int = 64):
        self._rings: List[HostNBB] = [HostNBB(capacity)
                                      for _ in range(nconsumers)]

    def insert_item(self, item: Any) -> List[int]:
        return [ring.insert_item(item) for ring in self._rings]

    def publish(self, item: Any) -> None:
        pending = set(range(len(self._rings)))
        backoff = transport.Backoff()
        while pending:
            for i in list(pending):
                if self._rings[i].insert_item(item) == nbb.OK:
                    pending.discard(i)
            if pending:
                backoff.wait(nbb.BUFFER_FULL)
            else:
                backoff.reset()

    def consumer(self, i: int) -> HostNBB:
        return self._rings[i]


class LockedQueue:
    """Mutex-guarded FIFO — the paper's lock-based baseline.

    Mirrors the MCAPI reference design: every insert/read takes the one lock,
    serializing all access to the shared structure.  Capacity-bounded to
    match NBB semantics (returns the same status codes for comparability).

    ``blocking=True`` makes put/get park on condition variables (kernel
    futex wait + context switch) — the reference implementation's actual
    behavior, and the convoy cost the paper measures.  The default spins
    with yield, a *more* charitable lock-based baseline.
    """

    def __init__(self, capacity: int, blocking: bool = False):
        self._capacity = capacity
        self._dq: deque = deque()
        self._lock = threading.Lock()
        self._blocking = blocking
        if blocking:
            self._not_full = threading.Condition(self._lock)
            self._not_empty = threading.Condition(self._lock)

    def insert_item(self, item: Any) -> int:
        with self._lock:
            if len(self._dq) >= self._capacity:
                return nbb.BUFFER_FULL
            self._dq.append(item)
            return nbb.OK

    def read_item(self) -> Tuple[int, Optional[Any]]:
        with self._lock:
            if not self._dq:
                return nbb.BUFFER_EMPTY, None
            return nbb.OK, self._dq.popleft()

    def send_burst(self, vals) -> Tuple[int, int]:
        """Burst insert under the one lock — the packet-mode baseline:
        the copy is amortized but every burst still serializes behind
        the same mutex the scalar ops take."""
        if not len(vals):               # NBB parity: empty burst is OK
            return nbb.OK, 0
        with self._lock:
            space = self._capacity - len(self._dq)
            if space <= 0:
                return nbb.BUFFER_FULL, 0
            m = min(space, len(vals))
            self._dq.extend(vals[i] for i in range(m))
            if self._blocking and m:
                self._not_empty.notify_all()
            return (nbb.OK, m) if m == len(vals) else (nbb.BUFFER_FULL, m)

    def drain_burst(self, max_n: Optional[int] = None) -> List[Any]:
        with self._lock:
            m = len(self._dq) if max_n is None else min(max_n, len(self._dq))
            out = [self._dq.popleft() for _ in range(max(m, 0))]
            if self._blocking and out:
                self._not_full.notify_all()
            return out

    # Transport protocol: the baseline speaks the same surface, so the A/B
    # benchmark swaps implementations without touching caller code.
    send = insert_item
    try_recv = read_item

    def send_i(self, payload: Any) -> transport.OpHandle:
        return transport.send_i(self, payload)

    def recv_i(self) -> transport.OpHandle:
        return transport.recv_i(self)

    def drain(self, max_items: Optional[int] = None) -> List[Any]:
        return transport.drain(self, max_items)

    def put(self, item: Any) -> None:
        if self._blocking:
            with self._not_full:
                while len(self._dq) >= self._capacity:
                    self._not_full.wait()
                self._dq.append(item)
                self._not_empty.notify()
            return
        transport.send_blocking(self, item)

    def get(self) -> Any:
        if self._blocking:
            with self._not_empty:
                while not self._dq:
                    self._not_empty.wait()
                item = self._dq.popleft()
                self._not_full.notify()
                return item
        status, item = transport.recv_blocking(self)
        assert status == nbb.OK
        return item
