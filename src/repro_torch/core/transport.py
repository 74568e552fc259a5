"""Unified lock-free Transport protocol — one wire format for every queue.

Every host-side communication primitive in this repo (SPSC/MPSC NBB rings,
the mutex baseline, NBW state cells, MCAPI channels) exposes the same
three operations:

  send(payload) -> status            non-blocking insert/publish
  try_recv()    -> (status, payload) non-blocking read
  drain(max_items) -> [payload, ..]  take everything available *now*
  send_burst(vals) -> (status, n)    packet-mode insert of a block
  drain_burst(max_n) -> [payload,..] packet-mode read of a block

with the paper's Table-1 status codes (``repro_torch.core.nbb``):

  OK                                   operation committed
  BUFFER_FULL                          stable:    yield, retry later
  BUFFER_FULL_BUT_CONSUMER_READING     transient: spin, retry immediately
  BUFFER_EMPTY                         stable:    yield, retry later
  BUFFER_EMPTY_BUT_PRODUCER_INSERTING  transient: spin, retry immediately

The split into *stable* and *transient* failures is the paper's retry
discipline: a transient status means the peer is mid-operation (an odd
counter) and will commit within a bounded number of instructions, so the
caller should busy-retry; a stable status means progress depends on the
peer being scheduled at all, so the caller should yield — and, if the
condition persists, back off exponentially rather than burn the core.
:class:`Backoff` packages that policy; :func:`send_blocking` /
:func:`recv_blocking` are the canonical retry loops built on it.

The burst pair is the paper's *packet mode* (Tables 5-7): per-exchange
overhead dominates when data moves one scalar at a time, so ring
transports reserve a contiguous slot span with ONE counter
announce/commit pair and move the whole block (``HostNBB.send_burst`` /
``drain_burst``); non-ring transports fall back to the generic loops
below, keeping the surface uniform.

STATE (NBW) cells join the protocol through :class:`StateTransport`,
which maps the NBW collision statuses onto Table 1 (a collision *is*
"producer inserting").  Scalar channels wrap any transport in a
:class:`CodecTransport` so the packing happens in the transport stack,
not in per-call ``ChannelType`` dispatch (see DESIGN.md §3).

Non-blocking operation handles (MCAPI ``mcapi_*_i`` / ``mcapi_test`` /
``mcapi_wait`` / ``mcapi_cancel``, paper §2): :func:`send_i` /
:func:`recv_i` return an :class:`OpHandle` immediately instead of
retrying inline.  The handle owns a two-state CAS FSM
(PENDING -> COMPLETED | CANCELLED, ``repro_torch.core.states``); callers
overlap their own work with the in-flight exchange and poll with
``test()``, park with ``wait()``, or abandon with ``cancel()`` — a
concurrent cancel and completion race through one CAS, so exactly one
terminal state wins.  The blocking calls below (:func:`send_blocking`,
:func:`recv_blocking`) are thin wrappers: handle + ``wait`` (DESIGN.md
§5).
"""
from __future__ import annotations

import time
from typing import Any, Callable, List, Optional, Protocol, Tuple, runtime_checkable

from repro_torch.core import faults, nbb, nbw, states
from repro_torch.core import interleave as _il

# Table-1 status codes, re-exported so transport users need one import.
OK = nbb.OK
BUFFER_FULL = nbb.BUFFER_FULL
BUFFER_FULL_BUT_CONSUMER_READING = nbb.BUFFER_FULL_BUT_CONSUMER_READING
BUFFER_EMPTY = nbb.BUFFER_EMPTY
BUFFER_EMPTY_BUT_PRODUCER_INSERTING = nbb.BUFFER_EMPTY_BUT_PRODUCER_INSERTING

#: Statuses where the peer is mid-operation: retry immediately (spin).
TRANSIENT = frozenset({BUFFER_FULL_BUT_CONSUMER_READING,
                       BUFFER_EMPTY_BUT_PRODUCER_INSERTING})


@runtime_checkable
class Transport(Protocol):
    """Anything that moves payloads with Table-1 status codes."""

    def send(self, payload: Any) -> int: ...

    def try_recv(self) -> Tuple[int, Optional[Any]]: ...

    def drain(self, max_items: Optional[int] = None) -> List[Any]: ...

    def send_i(self, payload: Any) -> "OpHandle": ...

    def recv_i(self) -> "OpHandle": ...

    def send_burst(self, vals) -> Tuple[int, int]: ...

    def drain_burst(self, max_n: Optional[int] = None) -> List[Any]: ...


class Backoff:
    """Bounded exponential backoff implementing the Table-1 retry discipline.

    Phase 1 — spin: transient statuses (peer mid-operation) busy-retry up
    to ``spins`` times; the peer commits within a bounded instruction count.
    Phase 2 — yield: stable statuses (or exhausted spins) give up the
    processor with ``sleep(0)`` for ``yields`` attempts.
    Phase 3 — sleep: persistent emptiness/fullness sleeps, doubling from
    ``sleep_init`` up to ``sleep_max`` — never a fixed busy-wait, never
    unbounded latency once work arrives.

    ``reset()`` after successful progress restores phase 1.
    """

    __slots__ = ("spins", "yields", "sleep_init", "sleep_max", "_attempt")

    def __init__(self, spins: int = 32, yields: int = 16,
                 sleep_init: float = 50e-6, sleep_max: float = 2e-3):
        self.spins, self.yields = spins, yields
        self.sleep_init, self.sleep_max = sleep_init, sleep_max
        self._attempt = 0

    def reset(self) -> None:
        self._attempt = 0

    def wait(self, status: int = BUFFER_EMPTY) -> None:
        """Wait appropriately for ``status``; escalates across calls."""
        if _il._active is not None:
            # Under the deterministic scheduler, waiting IS yielding: the
            # scheduler decides who runs next, so spinning or sleeping for
            # wall-clock time would only burn the model checker's budget
            # (and a time.sleep would deadlock the one-runner handshake).
            _il._active.yield_point("backoff.wait", status)
            return
        if status in TRANSIENT and self._attempt < self.spins:
            self._attempt += 1
            return                       # spin: retry immediately
        k = self._attempt - self.spins
        self._attempt += 1
        if k < self.yields:
            time.sleep(0)                # yield the processor
            return
        delay = min(self.sleep_init * (2 ** min(k - self.yields, 20)),
                    self.sleep_max)
        time.sleep(delay)


class OpHandle:
    """A non-blocking operation in flight (MCAPI ``mcapi_request_t``).

    Wraps one retriable attempt (a send or a receive) behind the
    PENDING -> COMPLETED | CANCELLED CAS FSM of ``repro_torch.core.states``:

      * ``test()``   — one poll: run the attempt once, commit on OK
                       (mcapi_test); never blocks.
      * ``wait()``   — poll under the Table-1 :class:`Backoff` discipline
                       until terminal, timeout, or ``should_stop``
                       (mcapi_wait).  A timeout leaves the handle PENDING
                       — the operation can still be polled or cancelled.
      * ``cancel()`` — CAS PENDING -> CANCELLED (mcapi_cancel).  Safe
                       from any thread; returns True iff this caller's
                       proposal won (the op will never commit as
                       COMPLETED).

    Threading contract: ``test``/``wait`` run the underlying queue
    operation, so they must be called from the thread that owns that
    side of the transport (the single producer for a send handle, the
    single consumer for a recv handle).  ``cancel`` only touches the
    FSM and may race from anywhere.  If an attempt's side effect lands
    in the same instant a cancel wins the CAS (the unavoidable window
    between the queue op and the commit CAS), the value is parked in
    ``late_result`` instead of being lost, and the handle still reports
    CANCELLED — exactly one terminal state, no double delivery.
    """

    __slots__ = ("_attempt", "_fsm", "result", "late_result", "last_status",
                 "attempted_ok")

    def __init__(self, attempt: Callable[[], Tuple[int, Any]],
                 name: str = "op"):
        self._attempt = attempt        # () -> (Table-1 status, payload)
        self._fsm = states.StateCell(states.OP_TRANSITIONS,
                                     states.OP_PENDING, name)
        self.result: Any = None        # payload once COMPLETED (None for send)
        self.late_result: Any = None   # side effect that lost the CAS race
        self.last_status = BUFFER_EMPTY  # last non-OK status observed
        self.attempted_ok = False      # the queue op itself committed

    @property
    def state(self) -> str:
        return self._fsm.state

    @property
    def done(self) -> bool:
        return self._fsm.state != states.OP_PENDING

    @property
    def completed(self) -> bool:
        return self._fsm.state == states.OP_COMPLETED

    @property
    def cancelled(self) -> bool:
        return self._fsm.state == states.OP_CANCELLED

    def test(self) -> bool:
        """One non-blocking poll; True iff the operation has completed."""
        s = self._fsm.state
        if s == states.OP_COMPLETED:
            return True
        if s == states.OP_CANCELLED:
            return False
        if _il._active is not None:
            _il._active.yield_point("op.attempt", id(self))
        status, payload = self._attempt()
        if status != OK:
            self.last_status = status
            return False
        self.attempted_ok = True
        if _il._active is not None:
            _il._active.yield_point("op.commit", id(self))
        if self._fsm.cas(states.OP_PENDING, states.OP_COMPLETED):
            self.result = payload
            return True
        self.late_result = payload     # cancel won; don't lose the item
        return False

    def wait(self, timeout_s: Optional[float] = None,
             backoff: Optional[Backoff] = None,
             should_stop: Optional[Callable[[], bool]] = None) -> bool:
        """Poll until terminal; True iff COMPLETED.  False on cancel,
        timeout, or ``should_stop`` (the handle stays PENDING on the
        latter two, so the caller may keep polling or cancel)."""
        b = backoff if backoff is not None else Backoff()
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        while True:
            if self.test():
                return True
            if self.cancelled:
                return False
            if should_stop is not None and should_stop():
                return False
            if deadline is not None and time.monotonic() > deadline:
                return False
            b.wait(self.last_status)

    def cancel(self) -> bool:
        """CAS PENDING -> CANCELLED; True iff this caller won."""
        if _il._active is not None:
            _il._active.yield_point("op.cancel", id(self))
        return self._fsm.cas(states.OP_PENDING, states.OP_CANCELLED)


def send_i(t: Transport, payload: Any) -> OpHandle:
    """Non-blocking send (``mcapi_msg_send_i``): returns an OpHandle after
    one eager attempt, so the uncontended case is already COMPLETED."""
    h = OpHandle(lambda: (t.send(payload), None), name="send_i")
    h.test()
    return h


def recv_i(t: Transport) -> OpHandle:
    """Non-blocking receive (``mcapi_msg_recv_i``): the received payload
    lands in ``handle.result``.  One eager attempt before returning."""
    h = OpHandle(t.try_recv, name="recv_i")
    h.test()
    return h


def send_blocking(t: Transport, payload: Any, *,
                  timeout_s: Optional[float] = None,
                  should_stop: Optional[Callable[[], bool]] = None) -> bool:
    """Blocking send = handle + wait (DESIGN.md §5 layering).  Returns
    False on timeout or when ``should_stop()`` turns true (payload not
    delivered)."""
    return send_i(t, payload).wait(timeout_s=timeout_s,
                                   should_stop=should_stop)


def recv_blocking(t: Transport, *, timeout_s: Optional[float] = None,
                  should_stop: Optional[Callable[[], bool]] = None
                  ) -> Tuple[int, Optional[Any]]:
    """Blocking receive = handle + wait; returns the last (status, None)
    on timeout/stop so callers can distinguish empty from delivered."""
    h = recv_i(t)
    if h.wait(timeout_s=timeout_s, should_stop=should_stop):
        return OK, h.result
    return h.last_status, None


def drain(t: Transport, max_items: Optional[int] = None) -> List[Any]:
    """Generic drain: repeated try_recv until a non-OK status.  Any
    transport gets this for free; implementations may override."""
    out: List[Any] = []
    while max_items is None or len(out) < max_items:
        status, payload = t.try_recv()
        if status != OK:
            break
        out.append(payload)
    return out


# ---------------------------------------------------------------------------
# Packet-mode burst exchange (paper Tables 5-7).  Ring transports override
# these with a true span reservation (one counter announce/commit pair and
# two slice copies — ``HostNBB.send_burst``/``drain_burst``); the generic
# forms below give every other transport the same surface by looping the
# scalar ops, so callers can always hand over a block and let the transport
# decide how much of the exchange is amortized.
# ---------------------------------------------------------------------------
def send_burst(t: Transport, vals) -> Tuple[int, int]:
    """Generic burst send: the longest prefix of ``vals`` the transport
    accepts.  Returns ``(status, n_sent)`` — OK iff everything landed,
    else the first non-OK status observed."""
    for i, v in enumerate(vals):
        status = t.send(v)
        if status != OK:
            return status, i
    return OK, len(vals)


def drain_burst(t: Transport, max_n: Optional[int] = None) -> List[Any]:
    """Generic burst drain: alias of :func:`drain` for transports with no
    native span reservation."""
    return drain(t, max_n)


class StateTransport:
    """NBW state cell as a Transport (paper §7 state-message policy).

    ``send`` never blocks and never reports FULL (the NBW Non-blocking
    property).  ``try_recv`` maps NBW statuses onto Table 1: a read
    collision or in-progress write is "producer inserting" (transient —
    spin and retry); an unpublished cell is plain EMPTY (stable).  A
    successful recv returns the *freshest* committed value; re-reads of
    the same value are legal (state semantics, not FIFO).
    """

    __slots__ = ("cell",)

    def __init__(self, cell: nbw.HostNBW):
        self.cell = cell

    def send(self, payload: Any) -> int:
        self.cell.write(payload)
        return OK

    def try_recv(self) -> Tuple[int, Optional[Any]]:
        status, value = self.cell.try_read()
        if status != nbw.OK:
            return BUFFER_EMPTY_BUT_PRODUCER_INSERTING, None
        if value is None:               # nothing published yet
            return BUFFER_EMPTY, None
        return OK, value

    def drain(self, max_items: Optional[int] = None) -> List[Any]:
        """At most one item: the freshest committed value.  Non-blocking:
        spins only through transient collisions (bounded by the writer's
        commit, per the NBW Timeliness property); stable EMPTY returns
        immediately like every other Transport."""
        for _ in range(64):
            status, value = self.try_recv()
            if status == OK:
                return [value]
            if status not in TRANSIENT:
                break
        return []

    def send_burst(self, vals) -> Tuple[int, int]:
        """State semantics: every value is published (writes never block);
        only the last one survives as the freshest committed state."""
        return send_burst(self, vals)

    def drain_burst(self, max_n: Optional[int] = None) -> List[Any]:
        """At most one item — the freshest committed value (see drain)."""
        if max_n is not None and max_n <= 0:
            return []
        return self.drain(max_n)

    def send_i(self, payload: Any) -> OpHandle:
        return send_i(self, payload)

    def recv_i(self) -> OpHandle:
        return recv_i(self)


class PriorityTransport:
    """Strict-priority fan over N inner transports: class 0 is the most
    urgent, and ``try_recv``/``drain`` always serve the lowest-numbered
    nonempty class first, FIFO within a class — the MCAPI "priority
    FIFO" delivery order MESSAGE channels document (the reference
    implementation's ``mcapi_msg_send`` priority argument).

    Composition keeps it lock-free: each class is its own SPSC ring, so
    the single-writer invariant holds per ring and the consumer's
    priority scan is just N non-blocking probes — no ordered shared
    structure, no lock (the same per-class-ring construction the serving
    engine's overload ``PriorityIntake`` (not yet ported) uses across
    producers).

    ``send`` without a priority lands in ``default_class`` (the least
    urgent, so unprioritized traffic never preempts prioritized);
    ``send_to`` targets an explicit class, clamped into range."""

    __slots__ = ("classes", "default_class")

    def __init__(self, classes: List["Transport"],
                 default_class: Optional[int] = None):
        if not classes:
            raise ValueError("PriorityTransport needs >= 1 class")
        self.classes = list(classes)
        self.default_class = (len(classes) - 1 if default_class is None
                              else default_class)

    def send(self, payload: Any) -> int:
        return self.classes[self.default_class].send(payload)

    def send_to(self, payload: Any, priority: int) -> int:
        p = max(0, min(len(self.classes) - 1, int(priority)))
        return self.classes[p].send(payload)

    def try_recv(self) -> Tuple[int, Optional[Any]]:
        busy = False
        for p, t in enumerate(self.classes):
            if _il._active is not None:
                _il._active.yield_point("transport.priority.scan",
                                        (id(self), p))
            status, payload = t.try_recv()
            if status == OK:
                return OK, payload
            if status in TRANSIENT:
                busy = True
        return ((BUFFER_EMPTY_BUT_PRODUCER_INSERTING if busy
                 else BUFFER_EMPTY), None)

    def drain(self, max_items: Optional[int] = None) -> List[Any]:
        return drain(self, max_items)

    def send_burst(self, vals) -> Tuple[int, int]:
        return self.classes[self.default_class].send_burst(vals)

    def drain_burst(self, max_n: Optional[int] = None) -> List[Any]:
        """Priority-ordered burst: one span reservation per class ring,
        most urgent first."""
        out: List[Any] = []
        for t in self.classes:
            take = None if max_n is None else max_n - len(out)
            if take is not None and take <= 0:
                break
            out.extend(t.drain_burst(take))
        return out

    def send_i(self, payload: Any) -> OpHandle:
        return send_i(self, payload)

    def recv_i(self) -> OpHandle:
        return recv_i(self)


class FaultyTransport:
    """Inject transport-site faults from a :class:`repro_torch.core.faults.FaultPlan`
    in front of any inner transport.  Refusals surface as the Table-1
    statuses the caller already handles (FULL on send, EMPTY on recv) —
    a fault at the transport layer is indistinguishable from pressure,
    which is the point: every retry loop in the system is exercised by
    the same plan that exercises the crash paths.

    The ``stall`` action models a producer dying mid-span-reservation:
    when the inner transport is a counter ring the announced-but-
    uncommitted span is actually left in the ring
    (:func:`repro_torch.core.faults.stall_mid_burst`) before a non-retryable
    :class:`~repro_torch.core.faults.InjectedFault` marks the producer dead.
    Recovery is the owner's job (``recover_ring``), mirroring the lease
    contract.

    Probes use the base site names (``transport.send`` etc.) so plans
    address a site class, not an instance; ``name`` only labels the
    wrapper for debugging."""

    __slots__ = ("inner", "plan", "name")

    def __init__(self, inner: Transport, plan: "faults.FaultPlan",
                 name: str = ""):
        self.inner, self.plan, self.name = inner, plan, name

    def _stall(self, vals) -> "Tuple[int, int]":
        ring = self.inner
        if hasattr(ring, "_uc"):
            faults.stall_mid_burst(ring, list(vals))
        raise faults.InjectedFault("transport.stall", self.plan.n_fired,
                                   retryable=False)

    def send(self, payload: Any) -> int:
        act = self.plan.fire("transport.send")
        if act is None:
            return self.inner.send(payload)
        if act == faults.ACT_RAISE:
            raise faults.InjectedFault("transport.send", self.plan.n_fired)
        return BUFFER_FULL

    def try_recv(self) -> Tuple[int, Optional[Any]]:
        act = self.plan.fire("transport.recv")
        if act is None:
            return self.inner.try_recv()
        if act == faults.ACT_RAISE:
            raise faults.InjectedFault("transport.recv", self.plan.n_fired)
        return BUFFER_EMPTY, None

    def drain(self, max_items: Optional[int] = None) -> List[Any]:
        act = self.plan.fire("transport.recv")
        if act is None:
            return self.inner.drain(max_items)
        if act == faults.ACT_RAISE:
            raise faults.InjectedFault("transport.recv", self.plan.n_fired)
        return []

    def send_burst(self, vals) -> Tuple[int, int]:
        act = self.plan.fire("transport.send_burst")
        if act == faults.ACT_STALL:
            return self._stall(vals)
        if act is not None:
            return BUFFER_FULL, 0
        if self.plan.fire("transport.stall") is not None:
            return self._stall(vals)
        return self.inner.send_burst(vals)

    def drain_burst(self, max_n: Optional[int] = None) -> List[Any]:
        act = self.plan.fire("transport.recv")
        if act is None:
            return self.inner.drain_burst(max_n)
        if act == faults.ACT_RAISE:
            raise faults.InjectedFault("transport.recv", self.plan.n_fired)
        return []

    def send_i(self, payload: Any) -> OpHandle:
        return send_i(self, payload)

    def recv_i(self) -> OpHandle:
        return recv_i(self)


class CodecTransport:
    """Encode/decode payloads over an inner transport (e.g. MCAPI scalar
    packing).  Pure composition: status codes pass through untouched."""

    __slots__ = ("inner", "encode", "decode")

    def __init__(self, inner: Transport, encode: Callable[[Any], Any],
                 decode: Callable[[Any], Any]):
        self.inner, self.encode, self.decode = inner, encode, decode

    def send(self, payload: Any) -> int:
        return self.inner.send(self.encode(payload))

    def try_recv(self) -> Tuple[int, Optional[Any]]:
        status, payload = self.inner.try_recv()
        if status == OK:
            payload = self.decode(payload)
        return status, payload

    def drain(self, max_items: Optional[int] = None) -> List[Any]:
        return [self.decode(p) for p in self.inner.drain(max_items)]

    def send_burst(self, vals) -> Tuple[int, int]:
        """Encode the block once, hand it to the inner ring's native span
        reservation — the packing rides the packet, not per-item calls.
        The whole block is encoded before the ring reports how much fits,
        so a caller retrying a rejected suffix re-encodes it; fine for
        the fire-and-forget streaming path, something to know for a
        tight retry loop under sustained backpressure."""
        return self.inner.send_burst([self.encode(v) for v in vals])

    def drain_burst(self, max_n: Optional[int] = None) -> List[Any]:
        return [self.decode(p) for p in self.inner.drain_burst(max_n)]

    def send_i(self, payload: Any) -> OpHandle:
        return send_i(self, payload)

    def recv_i(self) -> OpHandle:
        return recv_i(self)
