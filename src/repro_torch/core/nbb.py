"""Non-Blocking Buffer (NBB) — lock-free event-message FIFO ring buffer.

Faithful implementation of the algorithm the paper adopts from
Kim, Colmenares & Rim, "Efficient adaptations of the non-blocking buffer for
event message communication" (ISORC 2007), as refactored into MCAPI by
Harper & de Gooijer (2014), Section 3.

Two atomic counters guard disjoint sections of a circular ring buffer:

  * ``update_count`` (UC)      — owned by the single producer,
  * ``acknowledge_count`` (AC) — owned by the single consumer.

Each counter is incremented *twice* per operation: once before the slot
access starts and once after it completes, so an odd value means an
operation is in flight.  Items in the buffer = UC//2 - AC//2.  Producer and
consumer always address different slots, hence neither ever blocks the
other; operations that cannot proceed return one of the four status codes of
the paper's Table 1 instead of waiting.

Two variants are provided:

  * :class:`HostNBB` — a real lock-free SPSC queue for host-side Python
    threads (data pipeline -> trainer, request batcher -> serving engine).
    Under CPython, aligned int stores/loads and single-slot list assignment
    are atomic, so the single-writer-per-counter discipline is sound.
  * :class:`SimNBB` — an interleaving simulator that runs the
    half-increments as separate micro-ops, for property tests of the
    torn (odd-counter) states.

and the functional device form of the same state machine
(:class:`NBBState`, :func:`init`, :func:`size`, :func:`insert_item`,
:func:`read_item`) on tensors: statuses are int32 tensors and every
branch a ``torch.where``, so a sequence of operations on the card never
waits for the host.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import interleave as _il

# Deterministic-interleaving yield points (repro_torch.core.interleave): each
# shared-memory access below is preceded by one `_il._active is None`
# check — the same zero-overhead-unarmed contract as core/faults.py
# sites.  Armed, the access parks the task and the VirtualScheduler
# decides who advances, which is what lets the checker enumerate every
# counter/slot interleaving of this protocol.

# ---------------------------------------------------------------------------
# Status codes — Table 1 of the paper.
# ---------------------------------------------------------------------------
OK = 0
BUFFER_FULL = 1                          # caller should yield and retry later
BUFFER_FULL_BUT_CONSUMER_READING = 2     # retry immediately, bounded spins
BUFFER_EMPTY = 3                         # caller should yield and retry later
BUFFER_EMPTY_BUT_PRODUCER_INSERTING = 4  # retry immediately, bounded spins

STATUS_NAMES = {
    OK: "OK",
    BUFFER_FULL: "BUFFER_FULL",
    BUFFER_FULL_BUT_CONSUMER_READING: "BUFFER_FULL_BUT_CONSUMER_READING",
    BUFFER_EMPTY: "BUFFER_EMPTY",
    BUFFER_EMPTY_BUT_PRODUCER_INSERTING: "BUFFER_EMPTY_BUT_PRODUCER_INSERTING",
}


# ---------------------------------------------------------------------------
# Host (threaded) variant — genuine lock-free SPSC ring for CPython threads.
# ---------------------------------------------------------------------------
class HostNBB:
    """Single-producer single-consumer non-blocking buffer for host threads.

    ``insert_item`` may only ever be called from one thread, ``read_item``
    from one (possibly different) thread.  No locks anywhere: the producer is
    the sole writer of ``_uc`` and of the slot it addresses; the consumer is
    the sole writer of ``_ac``.  CPython guarantees the individual loads and
    stores are atomic, which is exactly the memory model the paper's
    PowerPC/x86 discussion (Section 3) relies on.
    """

    __slots__ = ("_n", "_slots", "_uc", "_ac")

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError("NBB capacity must be >= 1")
        self._n = capacity
        self._slots: list = [None] * capacity
        self._uc = 0  # update counter (producer-owned)
        self._ac = 0  # acknowledge counter (consumer-owned)

    @property
    def capacity(self) -> int:
        return self._n

    def __len__(self) -> int:  # snapshot; may be stale under concurrency
        return (self._uc // 2) - (self._ac // 2)

    def insert_item(self, item: Any) -> int:
        if _il._active is not None:
            _il._active.yield_point("nbb.send.load", id(self))
        uc = self._uc
        ac = self._ac  # single racy read — fine: AC only grows
        if (uc // 2) - (ac // 2) >= self._n:
            # Full.  Distinguish "consumer mid-read" (spin briefly) from
            # "consumer idle" (yield) exactly as the paper's Table 1.
            if ac & 1:
                return BUFFER_FULL_BUT_CONSUMER_READING
            return BUFFER_FULL
        if _il._active is not None:
            _il._active.yield_point("nbb.send.announce", id(self))
        self._uc = uc + 1                       # announce write-in-progress
        if _il._active is not None:
            _il._active.yield_point("nbb.send.slot",
                                    (id(self), (uc // 2) % self._n))
        self._slots[(uc // 2) % self._n] = item
        if _il._active is not None:
            _il._active.yield_point("nbb.send.commit", id(self))
        self._uc = uc + 2                       # commit
        return OK

    def read_item(self) -> Tuple[int, Optional[Any]]:
        if _il._active is not None:
            _il._active.yield_point("nbb.recv.load", id(self))
        ac = self._ac
        uc = self._uc  # single racy read — UC only grows
        if (uc // 2) == (ac // 2):
            if uc & 1:
                return BUFFER_EMPTY_BUT_PRODUCER_INSERTING, None
            return BUFFER_EMPTY, None
        if _il._active is not None:
            _il._active.yield_point("nbb.recv.announce", id(self))
        self._ac = ac + 1                       # announce read-in-progress
        idx = (ac // 2) % self._n
        if _il._active is not None:
            _il._active.yield_point("nbb.recv.slot", (id(self), idx))
        item = self._slots[idx]
        self._slots[idx] = None                 # help GC; slot now ours alone
        if _il._active is not None:
            _il._active.yield_point("nbb.recv.ack", id(self))
        self._ac = ac + 2                       # acknowledge
        return OK, item

    # -- packet-mode burst operations (paper Tables 5-7) ---------------------
    # One counter announce/commit pair moves a whole contiguous span, so a
    # K-item block costs one ring exchange instead of K scalar exchanges.
    # Safety is unchanged: the span only becomes visible to the peer at the
    # single commit store, and the peer cannot enter the span before it
    # (mid-burst, the odd counter reads as the Table-1 transient status).
    def send_burst(self, vals) -> Tuple[int, int]:
        """Producer-side packet insert of ``vals`` (a sequence).

        Reserves the longest prefix that fits and copies it with at most
        two slice assignments (wrap-around).  Returns ``(status, n)``
        where ``n`` items were enqueued: OK iff every item fit, else the
        Table-1 full status with ``n`` possibly 0 (full-ring refusal) —
        all-at-once visibility either way.
        """
        want = len(vals)
        if _il._active is not None:
            _il._active.yield_point("nbb.burst.load", id(self))
        uc = self._uc
        ac = self._ac  # single racy read — fine: AC only grows
        space = self._n - ((uc // 2) - (ac // 2))
        full = (BUFFER_FULL_BUT_CONSUMER_READING if ac & 1 else BUFFER_FULL)
        if want == 0:
            return OK, 0
        if space <= 0:
            return full, 0
        m = min(space, want)
        if _il._active is not None:
            _il._active.yield_point("nbb.burst.announce", id(self))
        self._uc = uc + 1                       # announce burst-in-progress
        start = (uc // 2) % self._n
        head = min(m, self._n - start)
        if _il._active is not None:
            _il._active.yield_point("nbb.burst.copy",
                                    (id(self), start, m, self._n))
        self._slots[start:start + head] = vals[:head]
        if m > head:                            # wrap-around: second slice
            self._slots[:m - head] = vals[head:m]
        if _il._active is not None:
            _il._active.yield_point("nbb.burst.commit", id(self))
        self._uc = uc + 2 * m                   # commit the whole span
        return (OK, m) if m == want else (full, m)

    def drain_burst(self, max_n: Optional[int] = None) -> list:
        """Consumer-side packet read: everything available now (bounded
        by ``max_n``), one announce/ack counter pair, at most two slice
        copies.  Empty list when nothing is committed."""
        if _il._active is not None:
            _il._active.yield_point("nbb.drain.load", id(self))
        ac = self._ac
        uc = self._uc  # single racy read — UC only grows
        avail = (uc // 2) - (ac // 2)
        if avail <= 0:
            return []
        m = avail if max_n is None else min(avail, max_n)
        if m <= 0:
            return []
        if _il._active is not None:
            _il._active.yield_point("nbb.drain.announce", id(self))
        self._ac = ac + 1                       # announce read-in-progress
        start = (ac // 2) % self._n
        head = min(m, self._n - start)
        if _il._active is not None:
            _il._active.yield_point("nbb.drain.copy",
                                    (id(self), start, m, self._n))
        out = self._slots[start:start + head]
        self._slots[start:start + head] = [None] * head     # help GC
        if m > head:
            out += self._slots[:m - head]
            self._slots[:m - head] = [None] * (m - head)
        if _il._active is not None:
            _il._active.yield_point("nbb.drain.ack", id(self))
        self._ac = ac + 2 * m                   # acknowledge the span
        return out

    # -- Transport protocol (repro_torch.core.transport) ---------------------------
    # insert/read already speak Table-1 statuses; the aliases make HostNBB a
    # structural Transport so channels/engines need no per-type dispatch.
    send = insert_item
    try_recv = read_item

    def send_i(self, payload: Any):
        """Non-blocking send returning an OpHandle (mcapi_msg_send_i)."""
        from repro_torch.core import transport  # late: transport imports this module
        return transport.send_i(self, payload)

    def recv_i(self):
        """Non-blocking receive returning an OpHandle (mcapi_msg_recv_i)."""
        from repro_torch.core import transport
        return transport.recv_i(self)

    def drain(self, max_items: Optional[int] = None) -> list:
        """Consumer-side: take every item available now (non-blocking)."""
        out = []
        while max_items is None or len(out) < max_items:
            status, item = self.read_item()
            if status != OK:
                break
            out.append(item)
        return out

    # Convenience blocking wrappers.  Both route through the Table-1
    # Backoff discipline (spin on transient, yield, then exponential
    # sleep — never a raw `sleep(0)` burn) and take an optional
    # deadline: a dead peer bounds the caller's wait instead of
    # spinning it forever outside the serve loop's watchdog.
    def put(self, item: Any, timeout_s: Optional[float] = None,
            backoff: Optional[Any] = None) -> bool:
        """Blocking insert.  True when delivered; False on deadline
        (``timeout_s``) with the item NOT enqueued."""
        from repro_torch.core import transport  # late: transport imports this module
        b = backoff if backoff is not None else transport.Backoff()
        deadline = (None if timeout_s is None
                    else time.monotonic() + timeout_s)
        while True:
            st = self.insert_item(item)
            if st == OK:
                return True
            if deadline is not None and time.monotonic() > deadline:
                return False
            b.wait(st)

    def get(self, timeout_s: Optional[float] = None,
            backoff: Optional[Any] = None) -> Any:
        """Blocking read.  Returns the item; raises ``TimeoutError`` on
        deadline (``timeout_s``) so an absent producer cannot park the
        caller forever."""
        from repro_torch.core import transport
        b = backoff if backoff is not None else transport.Backoff()
        deadline = (None if timeout_s is None
                    else time.monotonic() + timeout_s)
        while True:
            st, item = self.read_item()
            if st == OK:
                return item
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"NBB get(): no item within {timeout_s}s "
                    f"(last status {STATUS_NAMES[st]})")
            b.wait(st)


# ---------------------------------------------------------------------------
# Interleaving simulator — used by property tests to exercise the *torn*
# (odd-counter) states that the fused functional ops above never expose.
# It executes half-increments as separate micro-ops under an arbitrary
# producer/consumer interleaving, which is how we check the paper's Safety
# property (a successful read never observes a partially-written slot).
# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# Functional device variant (``core/nbb.py:288-353`` of the JAX package).
# ---------------------------------------------------------------------------
class NBBState(NamedTuple):
    """Pure-functional NBB state: each op returns a new state."""

    update_count: torch.Tensor       # int32 scalar, producer counter
    acknowledge_count: torch.Tensor  # int32 scalar, consumer counter
    slots: torch.Tensor              # [capacity, *item_shape]


def init(capacity: int, item: torch.Tensor) -> NBBState:
    """An empty NBB of ``capacity`` items shaped like ``item``, on its
    device."""
    z = torch.zeros((), dtype=torch.int32, device=item.device)
    return NBBState(z, z.clone(), torch.zeros(
        (capacity,) + tuple(item.shape), dtype=item.dtype,
        device=item.device))


def size(state: NBBState) -> torch.Tensor:
    return state.update_count // 2 - state.acknowledge_count // 2


def _pick(slots: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``slots[idx]`` for a 0-d index tensor, with no host read of it."""
    return torch.index_select(slots, 0, idx.reshape(1))[0]


def insert_item(state: NBBState, item: torch.Tensor
                ) -> Tuple[NBBState, torch.Tensor]:
    """Producer op -> (new state, status).  Never blocks: when the ring
    is full the state comes back unchanged with a BUFFER_FULL* status."""
    n = state.slots.shape[0]
    uc, ac = state.update_count, state.acknowledge_count
    full = (uc // 2 - ac // 2) >= n
    status = torch.where(
        full, torch.where(ac % 2 == 1, BUFFER_FULL_BUT_CONSUMER_READING,
                          BUFFER_FULL), OK).to(torch.int32)
    idx = (uc // 2) % n
    written = state.slots.index_copy(
        0, idx.reshape(1).long(), item.to(state.slots.dtype)[None])
    new_slots = torch.where(full, state.slots, written)
    # Both half-increments fused: no observer sits between them.
    new_uc = torch.where(full, uc, uc + 2)
    return NBBState(new_uc, ac, new_slots), status


def read_item(state: NBBState
              ) -> Tuple[NBBState, torch.Tensor, torch.Tensor]:
    """Consumer op -> (new state, item, status); ``item`` is zeros when
    the status is not OK (callers branch on it, as in the paper)."""
    n = state.slots.shape[0]
    uc, ac = state.update_count, state.acknowledge_count
    empty = (uc // 2) == (ac // 2)
    status = torch.where(
        empty, torch.where(uc % 2 == 1, BUFFER_EMPTY_BUT_PRODUCER_INSERTING,
                           BUFFER_EMPTY), OK).to(torch.int32)
    item = _pick(state.slots, ((ac // 2) % n).long())
    item = torch.where(empty, torch.zeros_like(item), item)
    new_ac = torch.where(empty, ac, ac + 2)
    return NBBState(uc, new_ac, state.slots), item, status


@dataclasses.dataclass
class SimNBB:
    capacity: int

    def __post_init__(self):
        self.uc = 0
        self.ac = 0
        self.slots = [(0, 0)] * self.capacity  # (value, torn_flag)

    # Producer micro-ops -----------------------------------------------------
    def try_begin_insert(self) -> int:
        if (self.uc // 2) - (self.ac // 2) >= self.capacity:
            return (BUFFER_FULL_BUT_CONSUMER_READING
                    if self.ac % 2 else BUFFER_FULL)
        self.uc += 1
        return OK

    def write_half(self, value):
        """First half of a non-atomic multi-word write: slot is torn."""
        self.slots[(self.uc // 2) % self.capacity] = (value, 1)

    def write_commit(self, value):
        self.slots[(self.uc // 2) % self.capacity] = (value, 0)
        self.uc += 1

    # Consumer micro-ops -----------------------------------------------------
    def try_begin_read(self) -> int:
        if (self.uc // 2) == (self.ac // 2):
            return (BUFFER_EMPTY_BUT_PRODUCER_INSERTING
                    if self.uc % 2 else BUFFER_EMPTY)
        self.ac += 1
        return OK

    def read_commit(self):
        value, torn = self.slots[(self.ac // 2) % self.capacity]
        self.ac += 1
        return value, torn
