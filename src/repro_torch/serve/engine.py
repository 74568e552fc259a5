"""Serving engine: lock-free request intake, iteration-level batching,
and the JAX package's five schedulers over a dense ring cache or the page
pool.

MCAPI topology, lock-free end to end (paper Figures 1-4 without the red
lock):

  client threads --SPSC NBB rings--> slot batcher --> chunk+decode -->
      --per-client SPSC response/stream rings--> clients

  * intake      — each client owns a private SPSC ring of an MpscQueue;
                  submission is a Transport ``send`` with Table-1 status
                  codes; the batcher drains via the same protocol.
  * lifecycle   — every request carries a CAS FSM cell (Figure 3):
                  FREE->VALID on submit, ->RECEIVED when bound,
                  ->COMPLETED on finish, ->CANCELLED on cancel/reject.
  * slots       — ``max_batch`` decode slots, each driven by the paper's
                  Figure-4 buffer FSM (FREE->RESERVED->ALLOCATED->
                  RECEIVED->FREE); finished sequences release their slot
                  and pages at block granularity and waiting requests
                  swap in without stopping decode.
  * schedulers  — ``slot_fused`` (default): a B=1 monolithic prefill per
                  admission (the Hopper flash-attention kernel on CUDA)
                  copied into the slot's row of a dense [max_batch,
                  max_len] ring cache, then fused K-step decode blocks
                  (the paged-attention kernel reading the ring as
                  identity-mapped pages); ``slot``: the same with one
                  decode step and one host sync per tick;
                  ``slot_chunked``: prompt chunks written in place into
                  the ring, riding the decode dispatch; ``slot_paged``:
                  the chunked discipline over the page pool; ``wave``:
                  batch-level waves (one B-row prefill, then lockstep
                  decode at a shared position, also on the flash kernel).
  * residency   — under ``slot_paged`` the pool's ``k``/``v`` tensors are
                  THE KV store; each slot holds only an int32 block-table
                  row and a length, new K/V is written in place at (page,
                  offset), and admission/retire reduce to editing int32
                  rows and refcounted pages — ``kv_copy_bytes`` stays 0
                  without CoW.  The dense schedulers use the pool for
                  admission accounting only.
  * dispatch    — the chunked schedulers make ONE ``Model.chunked_block``
                  call per tick: one prompt chunk per admitting slot plus
                  a K-step greedy decode block for every decoding slot,
                  and ONE device->host fetch of both together
                  (``stats["host_syncs"]``).
  * sharing     — (``slot_paged``) chained chunk hashes of the bucketed
                  prompt key a prefix cache of resident page runs: a hit
                  adopts the pages (refcount increments) and skips those
                  chunks.
  * streaming   — ``engine.connect(client_id)`` returns the client's
                  :class:`Session`; ``session.submit_i(...)`` returns a
                  :class:`RequestHandle` whose ``tokens()`` yields
                  ``(pos, token)`` pairs delivered in per-block BURSTS on
                  the client's SPSC stream ring, and whose ``cancel()``
                  CASes the request FSM so the batcher retires the slot
                  and frees its KV pages mid-decode.  The legacy
                  ``submit``/``get_response`` calls wrap session + handle.
  * overload    — an optional :class:`~repro_torch.serve.overload.
                  OverloadPolicy` turns the intake into the multi-class
                  weighted-fair fan-in (``submit_i(priority=...)``,
                  strict priority with aging + per-client WFQ over the
                  same lock-free SPSC rings), sheds queued requests past
                  their TTFT SLO with a typed falsy ``ShedStatus``, and —
                  under ``slot_paged`` — PREEMPTS lower-priority decoding
                  sequences when urgent work needs their slot or pages:
                  private KV pages swap host-side (shared prefix pages
                  stay resident), the Figure-4 cell parks in
                  BUFFER_PREEMPTED, and the sequence later resumes
                  byte-identically through the block-table indirection.
                  A parked row holds ``-1`` tombstones and never reaches a
                  dispatched block table (``_block_table`` refuses one).
  * robustness  — a seeded :class:`~repro_torch.core.faults.FaultPlan`
                  (``fault_plan=``) arms probes in the pool, the engine's
                  own rings and the dispatch (``engine.dispatch`` before
                  any device work, ``engine.sync`` after the fetch); the
                  tick watchdog catches every exception, retries a
                  transient one ``tick_retries`` times, then fails the
                  bound slots with a typed ``FailedStatus`` and keeps
                  serving.  Per-session leases (``lease_s=``) reap a
                  silent client's whole stake; a poisoned page write
                  quarantines its pages; ``Session.close`` cancels and
                  refuses; a dead engine resolves every handle at once.
  * recovery    — (``slot_paged``, ``snapshot_dir=``) crash-consistent
                  snapshots at tick boundaries (pool tables, refcounts and
                  written page bytes, slots, parked and queued requests,
                  undelivered terminals; ``serve/snapshot.py``) plus a
                  write-ahead intake journal of BIND records;
                  ``restore``/``restore_latest`` resume decode mid-stream
                  byte-identically, and ``serve_forever(restart=True)``
                  turns a loop crash into a restore.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import itertools
import math
import os
import threading
import time
from collections import deque
from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import faults as faults_mod
from repro_torch.core import nbb, states, transport
from repro_torch.core.host_queue import MpscQueue, SpscQueue
from repro_torch.models.model import prefix_chunk_hashes, resolve_device
from repro_torch.serve import snapshot as snapshot_mod
from repro_torch.serve.kv_cache import OK as POOL_OK
from repro_torch.serve.kv_cache import (PagedKVPool, PrefixCache,
                                        PrefixEntry, SwapImage)
from repro_torch.serve.overload import (OverloadPolicy, PriorityIntake,
                                        ShedStatus)
from repro_torch.serve.snapshot import SnapshotError

SCHEDULERS = ("slot_paged", "slot_chunked", "slot_fused", "slot", "wave")


@dataclasses.dataclass
class Request:
    req_id: int
    client_id: int
    prompt: np.ndarray                  # [T] int32
    max_tokens: int = 16
    eos_id: int = -1                    # -1: never
    fsm: states.StateCell = dataclasses.field(
        default_factory=lambda: states.request_cell())
    tokens_out: Optional[np.ndarray] = None
    submit_t: float = 0.0
    first_token_t: float = 0.0          # harvest time of token 0 (TTFT)
    done_t: float = 0.0
    token_ts: List[float] = dataclasses.field(default_factory=list)
    # Overload control.  ``priority`` is the submitted class (0 = most
    # urgent); ``eff_priority`` is what scheduling decisions read — it
    # starts equal and is boosted to 0 when aging promotes the request,
    # so a promotion also confers preemption immunity.  ``slo_s`` is a
    # per-request TTFT deadline overriding the policy default; ``status``
    # carries a typed terminal status (ShedStatus, FailedStatus) back to
    # the client handle.
    priority: int = 1
    eff_priority: int = 1
    slo_s: Optional[float] = None
    status: Optional[object] = None


@dataclasses.dataclass(frozen=True)
class TimeoutStatus:
    """Typed timeout from the client receive surface.  Falsy, so callers
    can write ``if not resp:`` without isinstance checks, and carries the
    last Table-1 status observed instead of a bare exception."""

    waited_s: float
    status: int = nbb.BUFFER_EMPTY

    def __bool__(self) -> bool:
        return False


@dataclasses.dataclass(frozen=True)
class OversizeStatus:
    """Typed fail-fast rejection from :meth:`Session.submit_i`: the
    request's KV footprint (bucketed prompt + generation budget) can
    never fit the engine's cache, so it is refused at the session layer
    without an intake round-trip — the batcher never sees it.  Falsy,
    like :class:`TimeoutStatus`."""

    prompt_len: int
    padded_len: int
    max_tokens: int
    max_len: int

    def __bool__(self) -> bool:
        return False


@dataclasses.dataclass(frozen=True)
class FailedStatus:
    """Typed terminal failure: the engine — not the client — ended this
    request, because a fault landed on its slot (watchdog fail-all,
    poisoned write), its lease expired, or the engine died; or the
    session was closed.  Falsy like :class:`TimeoutStatus`, with the
    human-readable ``reason`` attached;
    rides ``Request.status`` to the client handle, and is also what
    ``wait``/``get_response`` return when the whole engine is dead —
    nothing hangs on a dead engine."""

    reason: str

    def __bool__(self) -> bool:
        return False


# ---------------------------------------------------------------------------
# Streaming wire format: one packed int64 scalar per harvested token on the
# client's SPSC stream ring (the MCAPI scalar channel format), terminal
# Request objects on the response ring.  req_id rides in the top 16 bits —
# enough to demultiplex any realistic number of in-flight requests per
# client; ``pos`` is the output index, so clients reassemble by position.
# ---------------------------------------------------------------------------
_REQ_MASK = 0xFFFF


def pack_token_event(req_id: int, pos: int, token: int) -> int:
    return (((req_id & _REQ_MASK) << 48) | ((pos & 0xFFFF) << 32)
            | (token & 0xFFFFFFFF))


def unpack_token_event(ev: int) -> Tuple[int, int, int]:
    """-> (req_id mod 2^16, output position, token id)."""
    return (ev >> 48) & _REQ_MASK, (ev >> 32) & 0xFFFF, ev & 0xFFFFFFFF


class RequestHandle:
    """One in-flight request (the serving analogue of an ``OpHandle``).

    Returned by :meth:`Session.submit_i`.  The submission itself is a
    non-blocking operation handle over the client's private intake ring;
    ``test``/``wait``/``tokens`` poll it through, so a full intake ring
    delays — never blocks — the caller.  Thread contract: ``test``,
    ``wait`` and ``tokens`` belong to the owning client thread (they run
    the session's ring consumer); ``cancel`` may race from any thread.
    """

    def __init__(self, session: "Session", req: Request,
                 submit: Optional[transport.OpHandle]):
        self.req = req
        self._session = session
        self._submit = submit              # None: rejected at submit time
        self._tokens: deque = deque()      # (pos, token) routed by pump
        self._final: Optional[Request] = None
        # Typed falsy status (OversizeStatus when the session layer
        # refused the request without an intake round-trip, ShedStatus
        # when admission shed it past its SLO); None for every request
        # the engine actually served.
        self.status: Optional[object] = None

    @property
    def req_id(self) -> int:
        return self.req.req_id

    @property
    def submitted(self) -> bool:
        """The request has entered the engine's intake ring."""
        return self._submit is not None and self._submit.completed

    @property
    def done(self) -> bool:
        return self._final is not None

    @property
    def response(self) -> Optional[Request]:
        """The terminal Request (COMPLETED or CANCELLED), once delivered."""
        return self._final

    def _poll(self) -> bool:
        """One non-blocking progress attempt; True if anything moved.
        Owner-thread only — this is also where a cancelled-before-send
        request is finalized locally: the owner thread set (or didn't
        set) ``attempted_ok`` itself, so unlike ``cancel()`` it can
        trust the flag without racing an in-flight attempt."""
        if self._submit is None:            # fail-fast reject: terminal
            return False                    # was produced at submit time
        moved = False
        if not self._submit.done:
            moved = self._submit.test() or moved
        if (self._final is None and self._submit.cancelled
                and not self._submit.attempted_ok):
            # The payload never reached the intake ring; the engine will
            # never answer, so the terminal is produced here.
            self.req.done_t = time.monotonic()
            if self.req.tokens_out is None:
                self.req.tokens_out = np.zeros((0,), np.int32)
            self._session.forget(self.req.req_id)
            self._session._finalized.add(self.req.req_id)
            self._final = self.req
            return True
        moved = self._session.pump() or moved
        if self._final is None and self._session.engine.dead is not None:
            # The engine died after accepting this request: nothing will
            # ever deliver its terminal, so finalize locally with the
            # typed falsy FailedStatus instead of hanging until timeout.
            req = self.req
            if req.done_t == 0.0:
                req.done_t = time.monotonic()
            if req.tokens_out is None:
                req.tokens_out = np.zeros((0,), np.int32)
            if self.status is None:
                self.status = (req.status if req.status is not None else
                               FailedStatus(self._session.engine.dead))
            if req.status is None:
                req.status = self.status
            self._session.forget(req.req_id)
            self._session._finalized.add(req.req_id)
            self._final = req
            return True
        return moved

    def test(self) -> bool:
        """Non-blocking: True iff the request has reached a terminal
        state (its final Request is available)."""
        if self._final is None:
            self._poll()
        return self._final is not None

    def wait(self, timeout_s: Optional[float] = None
             ) -> Union[Request, TimeoutStatus, "FailedStatus"]:
        """Block (Backoff discipline) until terminal; the final Request,
        or a falsy TimeoutStatus with the handle still live.  On a dead
        engine this returns the falsy :class:`FailedStatus` immediately
        (reason attached) instead of hanging until timeout."""
        b = transport.Backoff()
        deadline = (None if timeout_s is None
                    else time.monotonic() + timeout_s)
        while self._final is None:
            if self._poll():
                b.reset()
                continue
            if deadline is not None and time.monotonic() > deadline:
                return TimeoutStatus(waited_s=timeout_s)
            b.wait(nbb.BUFFER_EMPTY)
        if (isinstance(self.status, FailedStatus)
                and self._session.engine.dead is not None):
            return self.status
        return self._final

    def tokens(self, timeout_s: Optional[float] = None
               ) -> Iterator[Tuple[int, int]]:
        """Yield ``(pos, token)`` as the batcher produces them.

        Tokens stream over the client's SPSC ring (one scalar per decode
        step); when backpressure dropped an event mid-stream, the missing
        positions are filled in from the terminal ``tokens_out`` — every
        position is delivered exactly once, in nondecreasing order except
        for those recovered gaps.  ``timeout_s`` is an *idle* timeout:
        raises TimeoutError only after that long with no progress at all
        (a slow but advancing generation never trips it)."""
        b = transport.Backoff()
        deadline = (None if timeout_s is None
                    else time.monotonic() + timeout_s)
        delivered = set()
        while True:
            while self._tokens:
                pos, tok = self._tokens.popleft()
                if pos not in delivered:
                    delivered.add(pos)
                    yield pos, tok
            if self._final is not None:
                out = self._final.tokens_out
                for p in range(0 if out is None else len(out)):
                    if p not in delivered:
                        yield p, int(out[p])
                return
            if self._poll():
                b.reset()
                if deadline is not None:        # progress: push it out
                    deadline = time.monotonic() + timeout_s
                continue
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"token stream idle for {timeout_s}s "
                    f"(request {self.req.req_id} not terminal)")
            b.wait(nbb.BUFFER_EMPTY)

    def cancel(self) -> bool:
        """Cancel from any thread.  Pure CAS proposals — no queue or
        registry mutation here, so it cannot race the owner thread's
        polling.  Exactly one of cancel()/completion wins the request
        FSM: on a mid-decode win the batcher retires the slot and frees
        its KV pages on its next tick, on an intake-pop win the batcher
        answers with the empty cancelled terminal, and a request whose
        submission never landed is finalized by the owner thread's next
        poll (see ``_poll``).  True iff this caller's proposal won
        somewhere along the pipeline."""
        sub_won = self._submit.cancel() if self._submit is not None else False
        fsm_won = (self.req.fsm.cas(states.REQUEST_VALID,
                                    states.REQUEST_CANCELLED)
                   or self.req.fsm.cas(states.REQUEST_RECEIVED,
                                       states.REQUEST_CANCELLED))
        return sub_won or fsm_won



class Session:
    """A client's streaming connection to the engine (``connect``).

    Owns the consumer side of the client's two SPSC rings: the *stream*
    ring (packed per-token scalars, best-effort) and the *response* ring
    (terminal Request objects, reliable).  ``pump`` demultiplexes both to
    the live handles by req_id; terminals without a live handle (legacy
    ``submit``, which detaches its handle) queue for ``next_response``.
    One session per client, created eagerly by the engine — the
    single-consumer invariant of the rings maps onto the one-client-one-
    thread contract.
    """

    def __init__(self, engine: "ServeEngine", client_id: int):
        self.engine = engine
        self.client_id = client_id
        # Terminals carry the full Request and route exactly by req_id;
        # the 16-bit wire id only routes the lossy token stream, where a
        # (vanishingly rare) mod-2^16 collision costs streamed tokens —
        # recovered from tokens_out at the terminal — never correctness.
        self._handles: Dict[int, RequestHandle] = {}    # full req_id
        self._by_mask: Dict[int, RequestHandle] = {}    # req_id & _REQ_MASK
        self._completed: deque = deque()
        # Terminal dedupe: a restore re-delivers the terminals that were
        # sitting undelivered in the response ring at snapshot time, so a
        # client that DID receive one before the crash may see it again —
        # the first delivery wins, duplicates are dropped here.
        self._finalized: set = set()
        # Closed sessions refuse new submits with an already-terminal
        # FailedStatus handle.
        self.closed = False
        # Lease heartbeat: any receive-side activity (pump) or a fresh
        # submit renews the client's lease; the engine's reaper treats a
        # client silent past ``lease_s`` as dead and reclaims its stake.
        self.last_pump_t = time.monotonic()

    def submit_i(self, prompt: np.ndarray, max_tokens: int = 16,
                 eos_id: int = -1, priority: Optional[int] = None,
                 slo_s: Optional[float] = None) -> RequestHandle:
        """Non-blocking submit: always returns a handle.  If the intake
        ring is full the submission stays PENDING and is retried by the
        handle's own polling (``test``/``wait``/``tokens``).

        ``priority`` is the request's class (0 = most urgent; None =
        PRIORITY_NORMAL) — honored when the engine runs an
        :class:`~repro_torch.serve.overload.OverloadPolicy`, where it
        selects the client's per-class intake ring; ignored otherwise.
        ``slo_s`` is a per-request TTFT deadline: the batcher sheds the
        request (falsy :class:`ShedStatus` in ``handle.status``) if it is
        still queued past the deadline.

        A request whose KV footprint can never fit the engine's cache
        (``padded prompt + max_tokens > max_len``) fails FAST, here at
        the session layer: the returned handle is already terminal
        (state CANCELLED, empty output) and carries a typed
        :class:`OversizeStatus` in ``handle.status`` — no intake
        round-trip, no batcher work, no pages touched."""
        eng = self.engine
        req = Request(next(eng._id), self.client_id,
                      np.asarray(prompt, np.int32), max_tokens, eos_id,
                      submit_t=time.monotonic())
        req.fsm.transition(states.REQUEST_FREE, states.REQUEST_VALID)
        if self.closed:
            req.fsm.transition(states.REQUEST_VALID,
                               states.REQUEST_CANCELLED)
            req.done_t = time.monotonic()
            req.tokens_out = np.zeros((0,), np.int32)
            h = RequestHandle(self, req, None)
            h._final = req
            h.status = req.status = FailedStatus("session closed")
            return h
        self.last_pump_t = time.monotonic()   # submitting client is alive
        if priority is not None:
            req.priority = req.eff_priority = int(priority)
        req.slo_s = slo_s
        padded = eng._footprint(len(req.prompt))
        if padded + max_tokens > eng.max_len:
            req.fsm.transition(states.REQUEST_VALID,
                               states.REQUEST_CANCELLED)
            req.done_t = time.monotonic()
            req.tokens_out = np.zeros((0,), np.int32)
            # Append-only log (the lock-free counter idiom): client
            # threads record fail-fast rejects without a read-modify-
            # write race against the batcher's stats dict.
            eng.oversize_log.append(req.req_id)
            h = RequestHandle(self, req, None)
            h._final = req
            h.status = OversizeStatus(len(req.prompt), padded, max_tokens,
                                      eng.max_len)
            return h
        if eng._ov is not None:
            req.priority = req.eff_priority = eng.intake.clamp(req.priority)
            ring = eng.intake.producer(self.client_id, req.priority)
        else:
            ring = eng.intake.producer(self.client_id)
        h = RequestHandle(self, req, transport.send_i(ring, req))
        self._handles[req.req_id] = h
        m = req.req_id & _REQ_MASK
        if m in self._by_mask:
            # Wire-id collision with a live handle: the 16-bit stream id
            # cannot distinguish the two, so disable stream routing for
            # both rather than risk misdelivering a token — each still
            # receives every token at its terminal.
            self._by_mask.pop(m)
        else:
            self._by_mask[m] = h
        return h

    def forget(self, req_id: int) -> Optional[RequestHandle]:
        """Detach a handle: its terminal Request is routed to the
        ``next_response`` queue instead (the legacy surface)."""
        h = self._handles.pop(req_id, None)
        if h is not None and self._by_mask.get(req_id & _REQ_MASK) is h:
            self._by_mask.pop(req_id & _REQ_MASK, None)
        return h

    def pump(self) -> bool:
        """Drain both rings once, non-blocking; route events to handles.
        Both drains are packet-mode bursts: one counter announce/commit
        pair takes every queued event per wakeup.  Returns True iff
        anything arrived."""
        self.last_pump_t = time.monotonic()     # lease heartbeat
        moved = False
        for ev in self.engine.streams[self.client_id].drain_burst():
            moved = True
            rid, pos, tok = unpack_token_event(ev)
            h = self._by_mask.get(rid)
            if h is not None:
                h._tokens.append((pos, tok))
        for req in self.engine.responses[self.client_id].drain_burst():
            moved = True
            if req.req_id in self._finalized:
                continue    # duplicate terminal re-delivered across a
                            # restart: exactly-once, first delivery won
            self._finalized.add(req.req_id)
            h = self.forget(req.req_id)
            if h is not None:
                if req.status is not None and h.status is None:
                    h.status = req.status
                h._final = req
            else:
                self._completed.append(req)
        return moved

    def next_response(self, timeout_s: float = 30.0
                      ) -> Union[Request, TimeoutStatus, FailedStatus]:
        """Next terminal Request in completion order (whole-response
        surface).  Falsy TimeoutStatus on timeout — never a bare raise;
        a falsy :class:`FailedStatus` at once on a dead engine."""
        b = transport.Backoff()
        deadline = time.monotonic() + timeout_s
        while True:
            if self._completed:
                return self._completed.popleft()
            if self.pump():
                b.reset()
                continue
            if self.engine.dead is not None:
                return FailedStatus(self.engine.dead)
            if time.monotonic() > deadline:
                return TimeoutStatus(waited_s=timeout_s)
            b.wait(nbb.BUFFER_EMPTY)

    def adopt(self, old: "Session") -> None:
        """Migrate a pre-restart session's state into this one: live
        handles re-home here (their ``_session`` is re-pointed so polling
        drains THIS engine's rings), the terminal-dedupe set and
        completed queue carry over, and — when this engine was restored
        from a snapshot — every live handle is re-bound to its restored
        Request.  The old session is left closed and empty; adopting is
        idempotent."""
        if old is self:
            return
        self._finalized |= old._finalized
        self._completed.extend(old._completed)
        for rid, h in list(old._handles.items()):
            h._session = self
            self._handles[rid] = h
            m = rid & _REQ_MASK
            if m in self._by_mask and self._by_mask[m] is not h:
                self._by_mask.pop(m)    # wire-id collision: same rule
            else:                       # as submit_i — disable both
                self._by_mask[m] = h
        old._handles.clear()
        old._by_mask.clear()
        old._completed.clear()
        old._finalized = set()
        old.closed = True
        if self.engine.restore_report is not None:
            self._rebind_restored()

    def _rebind_restored(self) -> None:
        """Post-restore handle reconciliation: a live handle whose
        request survived into the snapshot (or replayed from the journal)
        is re-pointed at the restored Request object — ``cancel()`` must
        CAS the FSM the engine actually schedules.  A handle the restored
        engine does not know (accepted after the last snapshot without a
        surviving journal record) finalizes NOW with a typed falsy
        FailedStatus: its request is gone; waiting would hang forever."""
        eng = self.engine
        report = eng.restore_report
        for rid, h in list(self._handles.items()):
            if h._final is not None:
                continue
            new_req = eng._restored_reqs.get(rid)
            if new_req is not None:
                if new_req is not h.req:
                    h.req = new_req
                continue
            req = h.req
            req.status = FailedStatus("lost across restart")
            if not req.fsm.cas(states.REQUEST_VALID,
                               states.REQUEST_CANCELLED):
                req.fsm.cas(states.REQUEST_RECEIVED,
                            states.REQUEST_CANCELLED)
            if req.done_t == 0.0:
                req.done_t = time.monotonic()
            if req.tokens_out is None:
                req.tokens_out = np.zeros((0,), np.int32)
            h.status = req.status
            self.forget(rid)
            self._finalized.add(rid)
            h._final = req
            if report is not None:
                report["failed"] = int(report.get("failed", 0)) + 1

    def close(self) -> None:
        """Explicit teardown (idempotent): cancel every in-flight
        handle, pump once so already-delivered terminals land, then
        refuse further submits.  The engine reclaims the cancelled
        requests' slots and pages on its next tick — close never blocks
        on the batcher, and the engine's delivery paths drop this
        client's traffic instead of retrying into rings nobody drains."""
        if self.closed:
            return
        for h in list(self._handles.values()):
            h.cancel()
        self.pump()
        self.closed = True
        self._handles.clear()
        self._by_mask.clear()

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()


@dataclasses.dataclass
class DecodeSlot:
    """One row of the dispatch batch, owned by at most one sequence at a
    time.  ``fsm`` is the paper's Figure-4 buffer cell — every occupancy
    change is a CAS transition, so a scheduler bug that double-books or
    early-frees a slot raises instead of corrupting KV."""

    index: int
    fsm: states.StateCell = dataclasses.field(
        default_factory=lambda: states.buffer_cell())
    request: Optional[Request] = None
    pos: int = 0                        # tokens written to this row's cache
    generated: int = 0
    next_tok: int = 0                   # harvested, not yet delivered
    outs: Optional[np.ndarray] = None
    prompt: Optional[np.ndarray] = None  # bucketed prompt being prefilled
    prefill_pos: int = 0                # prompt tokens streamed so far
    # Prefix sharing: the bound prompt's chained chunk hashes (registered
    # in-flight so burst duplicates defer instead of prefilling cold) and
    # the not-yet-cacheable (ready_at, key, n_tokens) insertions, consumed
    # in order as the written extent passes each entry's last page.
    chunk_hashes: Optional[List[int]] = None
    pending_prefix: List[Tuple[int, int, int]] = dataclasses.field(
        default_factory=list)
    # Keys whose cache entries THIS binding created — rolled back on
    # abort/reject so an all-or-nothing admission leaves no residue.
    created_prefixes: List[int] = dataclasses.field(default_factory=list)
    # Overload control: a just-resumed slot is immune to re-preemption
    # until it has decoded at least one block — without this, a
    # high-priority flood could swap the same victim in and out every
    # tick, paying swap traffic for zero forward progress.
    fresh_resume: bool = False


@dataclasses.dataclass
class ParkedSeq:
    """A preempted sequence parked off-slot: the host :class:`SwapImage`
    holding its private KV pages, plus everything the decode slot held so
    a resume restores the exact mid-decode state (the greedy continuation
    is byte-identical — block-table indirection makes the new physical
    page numbers invisible).  ``fsm`` is the sequence's Figure-4 buffer
    cell, parked in BUFFER_PREEMPTED; it travels with the sequence, and
    the vacated slot gets a fresh FREE cell.  ``bypassed`` counts resume
    attempts lost to more urgent intake — at the policy's aging limit
    the sequence is promoted (eff_priority 0) so preemption cannot
    starve it."""

    req: Request
    image: SwapImage
    prompt: np.ndarray
    outs: np.ndarray
    generated: int
    pos: int
    cur: int                            # last sampled token (resume feed)
    fsm: states.StateCell
    chunk_hashes: Optional[List[int]]
    pending_prefix: List[Tuple[int, int, int]]
    created_prefixes: List[int]
    bypassed: int = 0


def _cache_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a (nested) dense cache tree."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _cache_leaves(v)]
    return [tree]


def _write_slot_caches(full, one, slot: int) -> None:
    """Copy a B=1 prefilled dense cache into row ``slot`` of the batch
    cache, in place, leaf by leaf over the cache tree.  The batch axis of
    a leaf is the one where the two shapes differ (axis 1 of a uniform
    ``[L, B, size, Hkv, hd]`` ring, axis 2 of gemma's ``[nsb, per, B,
    ...]`` local rings; a static cross cache's sequence axis is its
    source length in both, so it differs on the batch axis alone); equal
    shapes (``max_batch`` 1) copy whole, as the JAX package's ``put``
    does (``engine.py:721-735`` there)."""
    if isinstance(full, dict):
        for name, f in full.items():
            _write_slot_caches(f, one[name], slot)
        return
    diff = [i for i in range(full.dim()) if full.shape[i] != one.shape[i]]
    if not diff:
        full.copy_(one)
        return
    if len(diff) != 1 or one.shape[diff[0]] != 1:
        raise ValueError(f"cache leaf {tuple(one.shape)} does not fit "
                         f"{tuple(full.shape)}")
    full.select(diff[0], slot).copy_(one.select(diff[0], 0))


class ServeEngine:
    def __init__(self, model, params, *, max_batch: int = 4,
                 max_len: int = 128, n_clients: int = 2,
                 pool_pages: int = 64, page_size: int = 16,
                 intake_depth: int = 32, stream_depth: int = 256,
                 scheduler: str = "slot_fused", k_max: int = 8,
                 k_free: int = 2, chunk_tokens: int = 16,
                 prefix_cache: bool = True,
                 overload: Optional[OverloadPolicy] = None,
                 fault_plan: Optional["faults_mod.FaultPlan"] = None,
                 lease_s: Optional[float] = None, tick_retries: int = 1,
                 snapshot_dir: Optional[str] = None,
                 snapshot_every: Optional[int] = None, device=None):
        if scheduler not in SCHEDULERS:
            raise ValueError(f"unknown scheduler {scheduler!r}")
        if k_max < 1 or k_free < 1:
            raise ValueError(f"need k_max >= 1 and k_free >= 1, "
                             f"got {k_max}/{k_free}")
        if not 1 <= chunk_tokens <= max_len:
            raise ValueError(f"need 1 <= chunk_tokens <= max_len, "
                             f"got {chunk_tokens}/{max_len}")
        if scheduler == "slot_chunked" and not model.chunkable:
            raise ValueError(
                f"{model.cfg.name}: slot_chunked needs position-indexed "
                "caches (recurrent mamba/rwkv state cannot be chunk-"
                "prefilled in place); use scheduler='slot_fused'")
        if scheduler == "slot_paged" and not model.pageable:
            raise ValueError(
                f"{model.cfg.name}: slot_paged needs one uniform position-"
                "indexed KV shape per layer (no sliding window, no "
                "recurrent/cross state); use scheduler='slot_chunked'")
        if (model.cfg.encoder is not None
                and scheduler in ("slot", "slot_fused", "wave")):
            # The JAX engine prefills through ``Model.prefill`` with no
            # frames: its encoder raises there, and the tick watchdog
            # swallows the error (``slot``, ``slot_fused``: the request
            # completes with a first token never computed) or the engine
            # dies (``wave``).  Refused here, on purpose.
            raise ValueError(
                f"{model.cfg.name}: {scheduler} prefills through the "
                "encoder, which needs frame embeddings the engine does not "
                "carry; use scheduler='slot_chunked'")
        if (overload is not None and overload.preemption
                and scheduler != "slot_paged"):
            raise ValueError(
                "overload.preemption needs scheduler='slot_paged': page-"
                "swap preemption parks pool pages behind the block table; "
                "the dense schedulers have no swappable residency")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model on {model.device}, engine on "
                             f"{self.device}")
        self.model, self.params = model, params
        self.max_batch, self.max_len = max_batch, max_len
        self.scheduler = scheduler
        self.chunk_tokens = chunk_tokens
        # k_max=1 is the legitimate scalar-equivalent fused setting;
        # clamp the under-capacity cap instead of rejecting it.
        self.k_max, self.k_free = k_max, min(k_free, k_max)
        cfg = model.cfg
        # Overload control: with a policy installed the flat MPSC fan-in
        # becomes the multi-class weighted-fair intake (same lock-free
        # per-client SPSC rings, one set per class).
        self._ov = overload
        self._intake_depth = intake_depth
        self._stream_depth = stream_depth
        self.intake = (PriorityIntake(n_clients, overload, intake_depth)
                       if overload is not None else
                       MpscQueue(n_clients,
                                 capacity_per_producer=intake_depth))
        self.responses = [SpscQueue(intake_depth) for _ in range(n_clients)]
        # Per-token scalars ride a separate SPSC ring so a slow streaming
        # consumer can never wedge terminal delivery (tokens are lossy
        # under backpressure, terminals are not).
        self.streams = [SpscQueue(stream_depth) for _ in range(n_clients)]
        self._sessions = [Session(self, c) for c in range(n_clients)]
        self.pool = PagedKVPool(
            pool_pages, page_size, n_layers=cfg.num_layers,
            kv_heads=max(cfg.num_kv_heads, 1), head_dim=cfg.head_dim_ or 1,
            dtype=cfg.compute_dtype, device=self.device)
        self._id = itertools.count()
        self._stop = threading.Event()
        self.slots = [DecodeSlot(i) for i in range(max_batch)]
        self._caches = None             # dense [L, max_batch, ...] ring cache
        # Paged residency (slot_paged): per-slot block-table width.  The
        # dense batch cache is never allocated; slots are int32 rows.
        self._max_pages = self.pool.pages_needed(max_len)
        self._cur = np.zeros((max_batch,), np.int32)
        self._pos = np.zeros((max_batch,), np.int32)
        # Prefix sharing: chained chunk hashes of the bucketed prompt
        # stream -> resident page runs.  Only the paged scheduler can
        # share (dense rows are per-slot by construction).
        self.prefix_cache = (PrefixCache(self.pool)
                             if scheduler == "slot_paged" and prefix_cache
                             else None)
        # Burst dedup: requests whose whole shareable prefix is being
        # prefilled by a bound slot RIGHT NOW wait here instead of
        # prefilling the same chunks cold (batcher-thread only).
        self._deferred: List[Tuple[Request, List[int]]] = []
        self._inflight: Dict[int, int] = {}   # chunk hash -> bound slots
        self._pending_bind: Dict[int, Tuple[List[int], int]] = {}
        # Preempted sequences parked off-slot, and per-class TTFT
        # samples (batcher-thread only).
        self._parked: List[ParkedSeq] = []
        self._ttft_by_class: Dict[int, List[float]] = {}
        self.stats = {"served": 0, "rejected": 0, "cancelled": 0,
                      "batches": 0, "decode_steps": 0, "admitted": 0,
                      "prefills": 0, "slot_busy_steps": 0,
                      "dropped_responses": 0, "dropped_stream_events": 0,
                      "host_syncs": 0, "ring_ops": 0, "fused_blocks": 0,
                      # Admission-plane counters, honest for every
                      # scheduler: dispatches that carried prefill work,
                      # prompt chunks materialized (a monolithic prefill
                      # is one whole-prompt chunk), dispatches that only
                      # copy a B=1 side cache into the batch cache, and
                      # decode-step opportunities active slots lost while
                      # a serial prefill ran (both 0 when chunked).
                      "prefill_dispatches": 0, "prefill_chunks": 0,
                      "cache_copy_dispatches": 0,
                      "admission_stall_steps": 0,
                      # Prefix sharing: admissions that adopted cached
                      # pages and the prompt positions never dispatched.
                      "prefix_hits": 0, "prefill_tokens_saved": 0,
                      # Overload control: page-swap preemptions/resumes
                      # (swap bytes mirror the pool's itemized counters)
                      # and requests shed at admission past their SLO.
                      "preemptions": 0, "resumes": 0, "shed_requests": 0,
                      "swap_in_bytes": 0, "swap_out_bytes": 0,
                      # Robustness: faults the armed plan fired, requests
                      # the ENGINE terminated (watchdog/lease/poison —
                      # distinct from client cancels and admission
                      # rejects), leases reaped, pages quarantined.
                      "faults_injected": 0, "requests_failed": 0,
                      "leases_reaped": 0, "pages_quarantined": 0,
                      # Crash recovery: snapshots written / bytes of the
                      # newest one, restores performed, journal records
                      # replayed as fresh submissions, in-process
                      # restarts.
                      "snapshots": 0, "snapshot_bytes": 0, "restores": 0,
                      "replayed_requests": 0, "restarts": 0}
        # Append-only log of fail-fast oversize rejects (written by
        # client threads in submit_i; list.append is the atomic).
        self.oversize_log: List[int] = []
        # -- robustness layer ----------------------------------------------
        if lease_s is not None and lease_s <= 0:
            raise ValueError(f"lease_s must be positive, got {lease_s}")
        if tick_retries < 0:
            raise ValueError(f"tick_retries must be >= 0, "
                             f"got {tick_retries}")
        self.faults = fault_plan
        self.pool.faults = fault_plan
        self.lease_s = lease_s
        self.tick_retries = int(tick_retries)
        # Set once by _die(): the engine can no longer make progress;
        # every receive surface observes it and resolves with a typed
        # falsy FailedStatus instead of hanging.
        self.dead: Optional[str] = None
        self._tick_failures = 0         # consecutive failed ticks (watchdog)
        self.tick_failures = 0          # every tick the watchdog caught
        self._reaped: set = set()       # clients whose lease was reaped
        # -- crash recovery ------------------------------------------------
        if snapshot_dir is not None and scheduler != "slot_paged":
            raise ValueError(
                "snapshot_dir needs scheduler='slot_paged': snapshots "
                "image the paged pool's block tables and pages; the "
                "dense schedulers have no host-recoverable KV state")
        if snapshot_every is not None and snapshot_dir is None:
            raise ValueError("snapshot_every requires snapshot_dir")
        if snapshot_every is not None and snapshot_every < 1:
            raise ValueError(f"snapshot_every must be >= 1, "
                             f"got {snapshot_every}")
        self._snap_dir = snapshot_dir
        self._snap_every = snapshot_every
        self._snap_requested = False    # signal-handler-safe flag
        self._in_tick = False           # snapshots only at tick boundaries
        self._ticks = 0
        self._restart_count = 0         # in-process restarts (not restored)
        self._params_digest: Optional[str] = None
        # Requests a restore re-queued ahead of the intake rings, in
        # deterministic order (snapshot-queued first, then journal
        # replay); consumed by _intake_recv before any ring pop.
        self._restore_queue: deque = deque()
        # req_id -> restored Request: what Session._rebind_restored uses
        # to re-point live handles after a restart.
        self._restored_reqs: Dict[int, Request] = {}
        self.restore_report: Optional[Dict[str, object]] = None
        self._journal: Optional[snapshot_mod.IntakeJournal] = None
        if snapshot_dir is not None:
            os.makedirs(snapshot_dir, exist_ok=True)
            self._journal = snapshot_mod.IntakeJournal(
                os.path.join(snapshot_dir, "journal.wal"))
        if fault_plan is not None:
            # Thread the plan through the engine's own delivery rings so
            # transport sites cover the token/terminal planes too (the
            # intake side probes in _intake_recv).
            self._wrap_rings()

    # -- client API (one thread per client) -------------------------------------
    def connect(self, client_id: int,
                resume: Optional[Session] = None) -> Session:
        """The client's streaming session.  One per client: the session
        owns the consumer side of the client's response/stream rings, so
        all receive-side calls for a client must come from one thread.
        Connecting RE-OPENS a closed session with a fresh lease.

        ``resume`` re-binds a pre-restart session's live handles onto
        this engine: handles whose requests the restored engine knows
        keep streaming mid-decode (clients dedupe by wire position, so
        delivery stays exactly-once across the restart); the rest
        finalize with a typed falsy FailedStatus instead of hanging."""
        sess = self._sessions[client_id]
        if sess.closed:
            sess.closed = False
            sess.last_pump_t = time.monotonic()
        if resume is not None and resume is not sess:
            sess.adopt(resume)
        return sess

    def submit(self, client_id: int, prompt: np.ndarray,
               max_tokens: int = 16, eos_id: int = -1,
               priority: Optional[int] = None,
               slo_s: Optional[float] = None) -> Optional[Request]:
        """Non-blocking submit (legacy whole-response surface): a thin
        wrapper over ``Session.submit_i`` that detaches the handle, so
        the terminal Request is delivered through ``get_response``.
        None => intake ring full (caller retries)."""
        session = self._sessions[client_id]
        h = session.submit_i(prompt, max_tokens, eos_id,
                             priority=priority, slo_s=slo_s)
        if h.status is not None:
            # Rejected fast at the session layer (oversize): route the
            # already-terminal Request to the legacy get_response queue.
            session._completed.append(h.response)
            return h.req
        if not h.submitted:
            h.cancel()                  # abandon the pending send ...
            h.test()                    # ... and finalize it (owner thread)
            return None
        session.forget(h.req_id)
        return h.req

    # -- shared helpers -----------------------------------------------------------
    def _respond(self, req: Request) -> None:
        # Response ring full => bounded backoff, never a spin-pin.  The
        # send can only fail during shutdown (should_stop) or, for a
        # client presumed dead (reaped lease), a closed session or a dead
        # engine, after a short timeout — nobody drains that ring, and the
        # batcher must not wedge on it; record the drop so stats never
        # overcount.
        self.stats["ring_ops"] += 1
        abandoned = (self.dead is not None
                     or req.client_id in self._reaped
                     or self._sessions[req.client_id].closed)
        if not transport.send_blocking(self.responses[req.client_id], req,
                                       timeout_s=0.05 if abandoned else None,
                                       should_stop=self._stop.is_set):
            self.stats["dropped_responses"] += 1

    def _stream_tokens(self, req: Request, first_pos: int, toks) -> None:
        """Best-effort packet-mode delivery: the whole harvested block
        for one request rides the client's stream ring as ONE burst.
        Whatever suffix does not fit is dropped (counted), and every
        dropped position is still delivered exactly once at completion
        via ``tokens_out`` (handles fill the gaps)."""
        if (self._sessions[req.client_id].closed
                or req.client_id in self._reaped):
            # Nobody drains this stream ring anymore.
            self.stats["dropped_stream_events"] += len(toks)
            return
        evs = [pack_token_event(req.req_id, first_pos + j, int(t))
               for j, t in enumerate(toks)]
        _, n = self.streams[req.client_id].send_burst(evs)
        self.stats["ring_ops"] += 1
        if n < len(evs):
            self.stats["dropped_stream_events"] += len(evs) - n

    def _reject(self, req: Request) -> None:
        # A concurrent client cancel() may have won the CAS already; the
        # request still gets exactly one terminal response either way.
        if req.fsm.cas(states.REQUEST_VALID, states.REQUEST_CANCELLED):
            self.stats["rejected"] += 1
        else:
            self.stats["cancelled"] += 1
        req.done_t = time.monotonic()
        if req.tokens_out is None:      # consistent terminal: empty, not None
            req.tokens_out = np.zeros((0,), np.int32)
        self._respond(req)

    def _finish_cancelled(self, req: Request) -> None:
        """Terminal delivery for a request the client cancelled before it
        reached a decode slot."""
        req.done_t = time.monotonic()
        if req.tokens_out is None:
            req.tokens_out = np.zeros((0,), np.int32)
        self.stats["cancelled"] += 1
        self._respond(req)

    # -- self-healing (fault injection + recovery) ------------------------------
    def _wrap_rings(self) -> None:
        """Put the fault plan on the engine's own delivery rings."""
        self.streams = [
            transport.FaultyTransport(r, self.faults, f"stream{c}")
            for c, r in enumerate(self.streams)]
        self.responses = [
            transport.FaultyTransport(r, self.faults, f"responses{c}")
            for c, r in enumerate(self.responses)]

    @staticmethod
    def _raw_ring(t):
        """The counter ring under a FaultyTransport wrapper (or ``t``
        itself): recovery code operates on the real ring, not through
        the fault layer."""
        return getattr(t, "inner", t)

    def _fault_raise(self, site: str, retryable: bool = True) -> None:
        """Engine-side injection probe (dispatch/sync sites)."""
        if self.faults is not None and self.faults.fire(site) is not None:
            raise faults_mod.InjectedFault(site, self.faults.n_fired,
                                           retryable=retryable)

    def _paused_plan(self):
        """Context: suspend fault firing while recovery code runs, so
        cleanup never recurses into fresh injected faults."""
        return (self.faults.pause() if self.faults is not None
                else contextlib.nullcontext())

    def _fail_slot(self, slot: DecodeSlot, reason: str) -> None:
        """Engine-initiated terminal for a bound slot (watchdog fail-all,
        lease reap, poisoned write): the mirror of ``_abort_slot`` with a
        typed FailedStatus and the ``requests_failed`` counter.  Partial
        output is delivered; cache insertions this binding created are
        rolled back and the pages freed — pool state returns exactly to
        pre-admission (minus any pages quarantine pinned first)."""
        req = slot.request
        req.status = FailedStatus(reason)
        req.tokens_out = slot.outs[:slot.generated].astype(np.int32)
        req.done_t = time.monotonic()
        if req.fsm.cas(states.REQUEST_RECEIVED, states.REQUEST_CANCELLED):
            self.stats["requests_failed"] += 1
        else:
            self.stats["cancelled"] += 1    # client cancel won the race
        self._rollback_created(slot)
        self.pool.free(req.req_id)
        self._respond(req)
        self._release_slot(slot)

    def _fail_queued(self, req: Request, reason: str) -> None:
        """Engine-initiated terminal for a request that never reached a
        slot (lease reap / dead-engine intake drain)."""
        req.status = FailedStatus(reason)
        if req.fsm.cas(states.REQUEST_VALID, states.REQUEST_CANCELLED):
            self.stats["requests_failed"] += 1
        else:
            self.stats["cancelled"] += 1
        req.done_t = time.monotonic()
        if req.tokens_out is None:
            req.tokens_out = np.zeros((0,), np.int32)
        self._respond(req)

    def _client_rings(self, client_id: int) -> List[object]:
        """The client's private intake ring(s): one flat MPSC ring, or
        one per priority class under an overload policy."""
        if self._ov is None:
            return [self.intake.producer(client_id)]
        return [q.producer(client_id) for q in self.intake._queues]

    def _reap_leases(self) -> bool:
        """Per-session leases: a client silent past ``lease_s`` — no
        pump, no submit — is presumed dead.  Its whole stake is reclaimed
        in one sweep: bound slots and parked images fail with a typed
        terminal, queued submissions (including a span its dying thread
        announced but never committed — ``recover_ring`` is legal exactly
        because the lease declared the producer dead) are drained and
        failed, and the engine adopts the consumer side of the abandoned
        stream ring so stale events can't pin it.  A client that pumps
        again after reaping simply renews its lease."""
        now = time.monotonic()
        worked = False
        for sess in self._sessions:
            c = sess.client_id
            if now - sess.last_pump_t <= self.lease_s:
                self._reaped.discard(c)     # heartbeat seen: renewed
                continue
            if c in self._reaped:
                continue
            self._reaped.add(c)     # responses to it are now time-bounded
            reason = (f"lease expired: client {c} silent > "
                      f"{self.lease_s:g}s")
            with self._paused_plan():
                had = False
                for slot in self.slots:
                    if (slot.request is not None
                            and slot.request.client_id == c):
                        self._fail_slot(slot, reason)
                        had = True
                for parked in [p for p in self._parked
                               if p.req.client_id == c]:
                    parked.req.status = FailedStatus(reason)
                    self._discard_parked(parked, failed=True)
                    self._parked.remove(parked)
                    had = True
                keep: List[Tuple[Request, List[int]]] = []
                for req, keys in self._deferred:
                    if req.client_id == c:
                        self._fail_queued(req, reason)
                        had = True
                    else:
                        keep.append((req, keys))
                self._deferred = keep
                for ring in self._client_rings(c):
                    faults_mod.recover_ring(ring)
                    for req in ring.drain_burst():
                        self._fail_queued(req, reason)
                        had = True
                if self._raw_ring(self.streams[c]).drain_burst():
                    had = True
            if had:
                self.stats["leases_reaped"] += 1
                worked = True
        return worked

    def _on_tick_fault(self, exc: Exception) -> Tuple[int, bool]:
        """The tick watchdog's catch half.  A retryable fault (an
        injected dispatch refusal, or any exception not marked
        otherwise) earns up to ``tick_retries`` whole-tick retries —
        pre-dispatch host bookkeeping is idempotent, so the retry simply
        reassembles and redispatches.  Past that (or on a non-retryable
        sync fault, where the device advanced beyond what the host
        harvested) every bound slot fails with a typed terminal and the
        engine KEEPS SERVING.  The engine's own rings are rolled back
        from any announced-but-uncommitted span first — the engine
        thread is their producer, so the rollback is always legal."""
        retryable = bool(getattr(exc, "retryable", True))
        self.tick_failures += 1
        self._tick_failures += 1
        if retryable and self._tick_failures <= self.tick_retries:
            return 0, True              # transient: next tick retries
        self._tick_failures = 0
        reason = f"tick failed: {exc!r}"
        with self._paused_plan():
            for t in list(self.streams) + list(self.responses):
                faults_mod.recover_ring(self._raw_ring(t))
            for slot in self.slots:
                if slot.request is None:
                    continue
                try:
                    self._fail_slot(slot, reason)
                except Exception:       # never re-raise out of tick
                    pass
        return 0, True

    def _die(self, reason: str) -> None:
        """Terminal engine failure (the loop itself crashed — beyond
        what fail-all-and-continue can heal): record the cause, resolve
        EVERY outstanding request with a typed falsy terminal, and leave
        ``dead`` set so every receive surface returns immediately
        instead of hanging on an engine that will never answer."""
        if self.dead is not None:
            return
        if self._snap_dir is not None and not self._in_tick:
            # Last-gasp checksummed snapshot, attempted only at a
            # consistent boundary (mid-tick state may be half-harvested —
            # then the last periodic snapshot stands).  The fault plan is
            # NOT paused here: a snapshot.write fault can tear this file,
            # and the loader's checksum falls back to the previous good
            # one — that path is part of the contract.
            with contextlib.suppress(Exception):
                self.save_snapshot()
        self.dead = reason
        self._stop.set()
        with self._paused_plan():
            for t in list(self.streams) + list(self.responses):
                faults_mod.recover_ring(self._raw_ring(t))
            for slot in self.slots:
                if slot.request is None:
                    continue
                try:
                    self._fail_slot(slot, reason)
                except Exception:
                    pass
            for parked in list(self._parked):
                parked.req.status = FailedStatus(reason)
                try:
                    self._discard_parked(parked, failed=True)
                except Exception:
                    pass
                self._parked.remove(parked)
            for req, _ in self._deferred:
                self._fail_queued(req, reason)
            self._deferred = []
            while True:
                status, req = self._intake_recv()
                if status != nbb.OK or req is None:
                    break
                self._fail_queued(req, reason)
        if self.faults is not None:
            self.stats["faults_injected"] = self.faults.n_fired

    def fault_report(self) -> Dict[str, object]:
        """Robustness snapshot (printed by launch/serve.py): the four
        robustness counters plus the fired-site log, the death reason and
        ``tick_failures``: every exception the tick watchdog caught,
        retried or not — a run without a fault plan must show 0, so a
        real device error cannot hide behind a successful retry."""
        if self.faults is not None:
            self.stats["faults_injected"] = self.faults.n_fired
        return {
            "faults_injected": self.stats["faults_injected"],
            "requests_failed": self.stats["requests_failed"],
            "leases_reaped": self.stats["leases_reaped"],
            "pages_quarantined": self.stats["pages_quarantined"],
            "quarantined_pages": sorted(self.pool.quarantined),
            "dead": self.dead,
            "tick_failures": self.tick_failures,
            "fired_sites": (list(self.faults.fired)
                            if self.faults is not None else []),
        }

    # ===========================================================================
    # Iteration-level scheduler: slot swap, no wave barrier.
    # ===========================================================================
    def _bucket(self, n: int) -> int:
        """Pad prompts to power-of-two buckets (>=8), left-padded — the
        same token streams as the JAX package's slot schedulers, so token
        sequences are comparable byte for byte."""
        b = 8
        while b < n:
            b *= 2
        return b

    def _padded_prompt(self, req: Request) -> np.ndarray:
        """The bucketed, left-padded token stream a slot actually
        prefills — also the stream prefix hashes are computed over, so
        padding is part of the hashed content."""
        padded = self._bucket(len(req.prompt))
        prompt = np.zeros((padded,), np.int32)
        prompt[padded - len(req.prompt):] = req.prompt      # left-pad
        return prompt

    def _footprint(self, prompt_len: int) -> int:
        """Cache positions a prompt occupies before generation starts,
        for the session layer's fail-fast oversize check: the bucketed
        length for the slot schedulers (they write at bucketed
        positions), the raw length for the wave scheduler (it pads only
        to the batch max)."""
        if self.scheduler == "wave":
            return prompt_len
        return self._bucket(prompt_len)

    def _dense_caches(self) -> Dict[str, Any]:
        """The persistent dense batch cache, allocated at first use."""
        if self._caches is None:
            self._caches = self.model.init_cache(self.max_batch,
                                                 self.max_len)
        return self._caches

    def dense_cache_bytes(self) -> int:
        """Footprint the dense [max_batch, max_len] batch cache occupies
        or WOULD occupy: the leaves of ``init_cache`` on the meta device
        (shapes alone; nothing is allocated), summed as the JAX package
        sums its abstract cache (``engine.py:1300-1308`` there).  The
        baseline ``kv_resident_bytes`` is compared against."""
        shapes = self.model.init_cache(self.max_batch, self.max_len,
                                       device="meta")
        return sum(t.numel() * t.element_size()
                   for t in _cache_leaves(shapes))

    def _block_table(self) -> np.ndarray:
        """Assemble this dispatch's [max_batch, max_pages] block table
        from the pool's per-sequence page lists.  This int32 write IS
        the whole "swap-in": residency never moves KV bytes.  Rows of
        free slots stay 0 — their writes go to the sink page and their
        reads are of stale, finite slots whose outputs are discarded.

        The kernels read ``block[b, key / ps]`` unchecked, so a ``-1``
        swap tombstone (a parked sequence's row) must never reach a
        dispatch: a negative page raises here, on the host table, before
        any device work — the decode loop gains no sync."""
        bt = np.zeros((self.max_batch, self._max_pages), np.int32)
        for s in self.slots:
            if s.request is not None:
                pages = self.pool.table(s.request.req_id).pages
                bt[s.index, :len(pages)] = pages
        if (bt < 0).any():
            rows = sorted({int(r) for r in np.nonzero(bt < 0)[0]})
            raise RuntimeError(f"block table rows {rows} hold a negative "
                               "page (a swap tombstone) at dispatch")
        return bt

    def _pop_next(self, slot: DecodeSlot) -> Optional[Request]:
        """Pop the next admissible request for ``slot``: pool-full
        requests are rejected (the NBB BUFFER_FULL discipline), requests
        cancelled while queued are answered with their empty terminal —
        the batcher never blocks behind either.  Returns None when the
        intake fan-in is empty.  Only the FIRST CHUNK's pages are claimed
        here; the reservation grows chunk by chunk.  A cached prefix hit
        skips those chunks entirely: admission adopts the cached pages
        (refcount increments + an int32 block-table row) and prefill
        resumes at the hit extent.  The monolithic-prefill schedulers
        claim the whole prompt + generation reservation up front."""
        while True:
            req, keys = self._next_candidate()
            if req is None:
                return None
            if self._ov is not None and self._should_shed(req):
                self._shed(req)
                continue
            padded = self._bucket(len(req.prompt))
            entry = None
            if keys:
                usable = self._usable_keys(padded, keys)
                if usable:
                    entry = self.prefix_cache.lookup(usable[::-1])
            if self.scheduler in ("slot_chunked", "slot_paged"):
                need = min(self.chunk_tokens, padded)
            else:
                need = padded + req.max_tokens
            if entry is not None:
                self.pool.adopt_shared(req.req_id, entry.pages,
                                       entry.n_tokens, slot=slot.index)
            elif not self._claim_admit(req, need, slot.index):
                self._reject(req)
                continue
            if not req.fsm.cas(states.REQUEST_VALID, states.REQUEST_RECEIVED):
                # Client cancelled while queued: give the pages straight
                # back and answer with the (empty) terminal.
                self.pool.free(req.req_id)
                self._finish_cancelled(req)
                continue
            if keys is not None:
                e_hit = entry.n_tokens if entry is not None else 0
                self._pending_bind[req.req_id] = (keys, e_hit)
                if entry is not None:
                    self.stats["prefix_hits"] += 1
                    self.stats["prefill_tokens_saved"] += e_hit
            return req

    def _usable_keys(self, padded: int, keys: List[int]) -> List[int]:
        """Hit candidates among a prompt's chained chunk hashes,
        ascending depth.  A hit must leave at least one prompt token to
        dispatch (the final chunk computes the first output token) and
        must cover at least one full page (sub-page sharing buys a
        whole-page CoW copy to reuse less than a page of KV)."""
        C, ps = self.chunk_tokens, self.pool.page_size
        return [keys[d] for d in range(len(keys))
                if ps <= (d + 1) * C < padded]

    def _defer_blocked(self, req: Request, keys: List[int]) -> bool:
        """True while some bound slot is prefilling this request's whole
        shareable prefix RIGHT NOW: admitting it cold would duplicate
        those chunk dispatches, so it waits for the cache entries the
        in-flight slot will publish."""
        usable = self._usable_keys(self._bucket(len(req.prompt)), keys)
        if not usable:
            return False
        deepest = usable[-1]
        return (deepest not in self.prefix_cache
                and self._inflight.get(deepest, 0) > 0)

    def _next_candidate(self) -> Tuple[Optional[Request],
                                       Optional[List[int]]]:
        """Next admission candidate: an unblocked deferred request
        first, else the intake fan-in (burst duplicates of an in-flight
        prefix are parked in ``_deferred`` instead of returned)."""
        if self.prefix_cache is not None:
            for i, (req, keys) in enumerate(self._deferred):
                if (req.fsm.state != states.REQUEST_VALID
                        or not self._defer_blocked(req, keys)):
                    del self._deferred[i]
                    return req, keys
        while True:
            status, req = self._intake_recv()
            if status != nbb.OK:
                return None, None
            if self.prefix_cache is None:
                return req, None
            keys = prefix_chunk_hashes(self._padded_prompt(req),
                                       self.chunk_tokens)
            if (req.fsm.state == states.REQUEST_VALID
                    and self._defer_blocked(req, keys)):
                self._deferred.append((req, keys))
                continue
            return req, keys

    def _bind_slot(self, slot: DecodeSlot, req: Request) -> None:
        """Figure-4 head: FREE -> RESERVED (pages claimed), the bucketed
        prompt staged for chunked prefill."""
        slot.fsm.transition(states.BUFFER_FREE, states.BUFFER_RESERVED)
        prompt = self._padded_prompt(req)
        slot.request = req
        slot.prompt = prompt
        slot.prefill_pos = 0
        slot.pos = 0
        slot.generated = 0
        slot.outs = np.full((req.max_tokens,), -1, np.int64)
        self._pos[slot.index] = 0
        self._cur[slot.index] = 0
        self.stats["admitted"] += 1
        if self._ov is not None:
            # WFQ accounting at BIND, not pop: only work that actually
            # claims capacity advances the client's virtual time, and
            # the cost is the KV footprint it will occupy.
            self.intake.charge(req.client_id, len(prompt) + req.max_tokens)
        info = self._pending_bind.pop(req.req_id, None)
        if info is not None:
            keys, e_hit = info
            slot.chunk_hashes = keys
            # Register the chain in-flight: burst duplicates defer on it
            # instead of prefilling the same chunks cold.
            for h in keys:
                self._inflight[h] = self._inflight.get(h, 0) + 1
            # Schedule cache insertions: entry d becomes cacheable when
            # the written extent passes its last page (ready_at), so the
            # writer never CoWs its own tail against the cache's refs.
            C, ps = self.chunk_tokens, self.pool.page_size
            slot.pending_prefix = [
                (math.ceil((d + 1) * C / ps) * ps, keys[d], (d + 1) * C)
                for d in range(len(keys)) if (d + 1) * C >= ps]
            if e_hit:
                # The hit chunks never dispatch: prefill resumes at the
                # cached extent over the adopted (shared) pages.
                slot.prefill_pos = e_hit
        if self._journal is not None:
            self._journal_bind(req)

    def _release_slot(self, slot: DecodeSlot) -> None:
        """Figure-4 tail shared by retire and abort.  A slot aborted
        while its prompt was still streaming in is still RESERVED and
        takes the direct RESERVED -> FREE edge."""
        if slot.fsm.state == states.BUFFER_RESERVED:
            slot.fsm.transition(states.BUFFER_RESERVED, states.BUFFER_FREE)
        else:
            slot.fsm.transition(states.BUFFER_ALLOCATED,
                                states.BUFFER_RECEIVED)
            slot.fsm.transition(states.BUFFER_RECEIVED, states.BUFFER_FREE)
        self._drop_inflight(slot.chunk_hashes)
        slot.chunk_hashes = None
        slot.pending_prefix = []
        slot.created_prefixes = []
        slot.request = None
        slot.outs = None
        slot.prompt = None
        slot.prefill_pos = 0
        self._cur[slot.index] = 0
        self._pos[slot.index] = 0

    def _drop_inflight(self, keys: Optional[List[int]]) -> None:
        """Deregister a binding's chunk-hash chain from the in-flight
        dedup map."""
        if keys:
            for h in keys:
                n = self._inflight.get(h, 0) - 1
                if n <= 0:
                    self._inflight.pop(h, None)
                else:
                    self._inflight[h] = n

    def _maybe_insert_prefixes(self, slot: DecodeSlot,
                               final: bool = False) -> None:
        """Publish a bound sequence's cacheable prefixes once the written
        extent passes each entry's last page (earlier, the still-writing
        owner would CoW its own tail).  At retire (``final``) everything
        left publishes: the owner never writes again."""
        if self.prefix_cache is None or not slot.pending_prefix:
            return
        extent = max(slot.prefill_pos, slot.pos)
        pages = self.pool.table(slot.request.req_id).pages
        ps = self.pool.page_size
        while slot.pending_prefix:
            ready_at, key, n_tok = slot.pending_prefix[0]
            if not final and extent < ready_at:
                break
            if self.prefix_cache.insert(key, n_tok,
                                        pages[:math.ceil(n_tok / ps)]):
                slot.created_prefixes.append(key)
            slot.pending_prefix.pop(0)

    def _retire(self, slot: DecodeSlot) -> None:
        """End-of-step release: slot + KV pages return to the pool the
        moment a sequence finishes."""
        req = slot.request
        req.tokens_out = slot.outs[:slot.generated].astype(np.int32)
        req.done_t = time.monotonic()
        # A client cancel() can win the finish-line CAS; either way the
        # pages are freed exactly once, here, by the batcher.
        if req.fsm.cas(states.REQUEST_RECEIVED, states.REQUEST_COMPLETED):
            self.stats["served"] += 1
        else:
            self.stats["cancelled"] += 1
        if self._ov is not None and req.first_token_t:
            self._ttft_by_class.setdefault(req.priority, []).append(
                req.first_token_t - req.submit_t)
        self._maybe_insert_prefixes(slot, final=True)
        self.pool.free(req.req_id)
        self._respond(req)
        self._release_slot(slot)

    def _abort_slot(self, slot: DecodeSlot) -> None:
        """Mid-decode cancellation: the client's CAS won, so retire the
        slot NOW — its KV pages return to the pool and the terminal
        (partial ``tokens_out``, state CANCELLED) is delivered."""
        req = slot.request
        req.tokens_out = slot.outs[:slot.generated].astype(np.int32)
        req.done_t = time.monotonic()
        self._rollback_created(slot)
        self.pool.free(req.req_id)
        self.stats["cancelled"] += 1
        self._respond(req)
        self._release_slot(slot)

    def _rollback_created(self, slot: DecodeSlot) -> None:
        """The prefix entries THIS binding created are withdrawn, so an
        aborted admission leaves the pool exactly as it found it."""
        if self.prefix_cache is not None:
            for key in slot.created_prefixes:
                self.prefix_cache.evict_key(key)
            slot.created_prefixes = []

    def _reject_streaming(self, slot: DecodeSlot) -> None:
        """Mid-stream pool exhaustion: the whole admission rolls back —
        pages freed, RESERVED slot released, the rejected terminal
        delivered."""
        req = slot.request
        self._rollback_created(slot)
        self.pool.free(req.req_id)
        if req.fsm.cas(states.REQUEST_RECEIVED, states.REQUEST_CANCELLED):
            self.stats["rejected"] += 1
        else:
            self.stats["cancelled"] += 1    # client cancel won the race
        req.done_t = time.monotonic()
        req.tokens_out = np.zeros((0,), np.int32)
        self._respond(req)
        self._release_slot(slot)

    # -- overload control ---------------------------------------------------
    def _intake_recv(self) -> Tuple[int, Optional[Request]]:
        """One intake pop.  Restored/replayed submissions first; then,
        under an overload policy, the multi-class pop — a request served
        by AGING over a more urgent nonempty class is promoted
        (eff_priority 0) so the bypass that earned its turn also shields
        it from instant preemption."""
        if self._restore_queue:
            # Restored/replayed submissions admit ahead of the (fresh,
            # empty) intake rings, in the deterministic order restore
            # queued them — no fault probe: these already paid intake
            # once, in their previous life.
            return nbb.OK, self._restore_queue.popleft()
        if self.faults is not None and \
                self.faults.fire("transport.recv") is not None:
            return nbb.BUFFER_EMPTY, None   # injected: pop refused
        if self._ov is None:
            return self.intake.try_recv()
        status, req, promoted = self.intake.pop()
        if status == nbb.OK and promoted:
            req.eff_priority = 0
        return status, req

    def _should_shed(self, req: Request) -> bool:
        """SLO-aware admission: True when the request's TTFT deadline
        (its own ``slo_s``, else the policy default) already passed
        while it sat queued."""
        slo = req.slo_s if req.slo_s is not None else self._ov.slo_s
        return slo is not None and time.monotonic() - req.submit_t > slo

    def _shed(self, req: Request) -> None:
        """Shed at intake: typed falsy ShedStatus on the terminal, no
        pages claimed, no slot bound, no device work (work not yet
        started is refused; work in flight is preempted, never
        discarded)."""
        slo = req.slo_s if req.slo_s is not None else self._ov.slo_s
        req.status = ShedStatus(time.monotonic() - req.submit_t, slo,
                                req.priority)
        if req.fsm.cas(states.REQUEST_VALID, states.REQUEST_CANCELLED):
            self.stats["shed_requests"] += 1
        else:
            self.stats["cancelled"] += 1    # client cancel won the race
        req.done_t = time.monotonic()
        req.tokens_out = np.zeros((0,), np.int32)
        self._respond(req)

    def _choose_victim(self, needer_cls: int) -> Optional[DecodeSlot]:
        """The slot to preempt so class ``needer_cls`` can run: strictly
        lower-priority than the needer (equal class never preempts),
        actively decoding (generated > 0: a mid-prefill slot has no
        harvested state to park), and not just resumed
        (``fresh_resume``).  Among candidates: worst class first, then
        the fewest written tokens (cheapest swap), then youngest."""
        cands = [s for s in self.slots
                 if s.request is not None and s.generated > 0
                 and not s.fresh_resume
                 and s.request.eff_priority > needer_cls]
        if not cands:
            return None
        return max(cands, key=lambda s: (s.request.eff_priority, -s.pos,
                                         s.request.req_id))

    def _claim_admit(self, req: Request, need: int, slot_index: int) -> bool:
        """``try_admit`` with the preemption escape hatch: under pool
        pressure a lower-priority decoding slot is swapped out and the
        claim retried."""
        while True:
            if self.pool.try_admit(req.req_id, need,
                                   slot=slot_index) == POOL_OK:
                return True
            if self._ov is None or not self._ov.preemption:
                return False
            victim = self._choose_victim(req.eff_priority)
            if victim is None or not self._preempt_slot(victim):
                return False

    def _extend_with_preemption(self, s: DecodeSlot, need: int) -> bool:
        """Chunk-assembly reservation growth with the same escape hatch.
        Victims are decoding rows, never the streaming slot itself, and
        the preempted row simply drops out of this tick's dispatch
        (``active`` is assembled afterwards)."""
        while True:
            if self.pool.extend_reservation(s.request.req_id,
                                            need) == POOL_OK:
                return True
            if self._ov is None or not self._ov.preemption:
                return False
            victim = self._choose_victim(s.request.eff_priority)
            if victim is None or not self._preempt_slot(victim):
                return False

    def _preempt_slot(self, slot: DecodeSlot) -> bool:
        """Park ``slot``'s sequence host-side (ALLOCATED -> PREEMPTED).
        The pool swaps out only the sequence's PRIVATE pages; the
        Figure-4 cell travels with the parked sequence and the slot gets
        a fresh FREE cell.  False when an injected ``pool.swap_out``
        fault lands: the probe raises before any pool mutation, so the
        victim keeps decoding untouched."""
        req = slot.request
        try:
            image = self.pool.swap_out_preempt(req.req_id, slot.pos)
        except faults_mod.InjectedFault:
            return False                # pre-mutation: victim unharmed
        self.stats["host_syncs"] += 1   # the gather's device->host fetch
        slot.fsm.transition(states.BUFFER_ALLOCATED, states.BUFFER_PREEMPTED)
        self._parked.append(ParkedSeq(
            req=req, image=image, prompt=slot.prompt, outs=slot.outs,
            generated=slot.generated, pos=slot.pos,
            cur=int(self._cur[slot.index]), fsm=slot.fsm,
            chunk_hashes=slot.chunk_hashes,
            pending_prefix=list(slot.pending_prefix),
            created_prefixes=list(slot.created_prefixes)))
        self._drop_inflight(slot.chunk_hashes)
        slot.fsm = states.buffer_cell()
        slot.request = None
        slot.prompt = None
        slot.outs = None
        slot.generated = 0
        slot.pos = 0
        slot.prefill_pos = 0
        slot.next_tok = 0
        slot.chunk_hashes = None
        slot.pending_prefix = []
        slot.created_prefixes = []
        slot.fresh_resume = False
        self._cur[slot.index] = 0
        self._pos[slot.index] = 0
        self.stats["preemptions"] += 1
        self.stats["swap_out_bytes"] = self.pool.swap_out_bytes
        return True

    def _resume_parked(self, slot: DecodeSlot, parked: ParkedSeq) -> bool:
        """Swap a parked sequence back into ``slot`` (PREEMPTED ->
        ALLOCATED).  False on POOL_FULL with nothing changed.  On success
        the slot adopts the parked cell and the exact mid-decode state,
        so the next block continues the greedy stream byte-identically."""
        req = parked.req
        if self.pool.swap_in_preempt(req.req_id, parked.image) != POOL_OK:
            return False
        parked.fsm.transition(states.BUFFER_PREEMPTED,
                              states.BUFFER_ALLOCATED)
        slot.fsm = parked.fsm
        slot.request = req
        slot.prompt = parked.prompt
        slot.outs = parked.outs
        slot.generated = parked.generated
        slot.pos = parked.pos
        slot.prefill_pos = len(parked.prompt)
        slot.next_tok = parked.cur
        slot.chunk_hashes = parked.chunk_hashes
        if parked.chunk_hashes:
            for h in parked.chunk_hashes:
                self._inflight[h] = self._inflight.get(h, 0) + 1
        slot.pending_prefix = parked.pending_prefix
        slot.created_prefixes = parked.created_prefixes
        slot.fresh_resume = True
        self._cur[slot.index] = parked.cur
        self._pos[slot.index] = parked.pos
        self.pool.table(req.req_id).slot = slot.index
        self.stats["resumes"] += 1
        self.stats["swap_in_bytes"] = self.pool.swap_in_bytes
        return True

    def _try_resume(self, slot: DecodeSlot) -> bool:
        """Offer a free slot to the most urgent parked sequence.  More
        urgent *intake* work wins the slot instead — but only
        ``aging_limit`` times, after which the parked sequence is
        promoted.  Under pool pressure the resume may itself preempt a
        strictly lower-priority running slot."""
        if not self._parked:
            return False
        cand = min(self._parked,
                   key=lambda p: (p.req.eff_priority, p.req.req_id))
        best = self.intake.highest_pending_class()
        if best is not None and best < cand.req.eff_priority:
            if cand.bypassed < self._ov.aging_limit:
                cand.bypassed += 1
                return False
            cand.req.eff_priority = 0   # aged: promoted + immune
        if not self._resume_parked(slot, cand):
            if not self._ov.preemption:
                return False
            victim = self._choose_victim(cand.req.eff_priority)
            if victim is None or not self._preempt_slot(victim):
                return False
            if not self._resume_parked(slot, cand):
                return False
        self._parked.remove(cand)
        return True

    def _discard_parked(self, parked: ParkedSeq, failed: bool = False) -> None:
        """Terminal delivery for a sequence cancelled while parked
        (PREEMPTED -> FREE): partial output from the parked state, cache
        insertions this binding created rolled back, pages freed (the
        swap tombstones are skipped).  ``failed``: engine-initiated
        (lease reap / dead engine) rather than a client cancel — counted
        under ``requests_failed``; the caller set the FailedStatus."""
        req = parked.req
        req.tokens_out = parked.outs[:parked.generated].astype(np.int32)
        req.done_t = time.monotonic()
        if self.prefix_cache is not None:
            for key in parked.created_prefixes:
                self.prefix_cache.evict_key(key)
        self.pool.free(req.req_id)
        parked.fsm.transition(states.BUFFER_PREEMPTED, states.BUFFER_FREE)
        if failed and req.fsm.cas(states.REQUEST_RECEIVED,
                                  states.REQUEST_CANCELLED):
            self.stats["requests_failed"] += 1
        else:
            if failed:
                req.fsm.cas(states.REQUEST_VALID, states.REQUEST_CANCELLED)
            self.stats["cancelled"] += 1
        self._respond(req)

    def class_ttft(self) -> Dict[int, Dict[str, float]]:
        """Per-priority-class TTFT summary {class: {n, p50_ms, p99_ms}}
        over retired requests (overload policy active)."""
        out: Dict[int, Dict[str, float]] = {}
        for cls in sorted(self._ttft_by_class):
            xs = sorted(self._ttft_by_class[cls])
            out[cls] = {
                "n": len(xs),
                "p50_ms": 1e3 * xs[len(xs) // 2],
                "p99_ms": 1e3 * xs[min(len(xs) - 1, int(0.99 * len(xs)))],
            }
        return out

    def _finished(self, req: Request, tok: int, generated: int,
                  pos: int) -> bool:
        """THE per-token retire predicate.  ``Model.decode_loop`` masks
        the same three conditions on device — keep the pair in lockstep."""
        return (tok == req.eos_id or generated >= req.max_tokens
                or pos + 1 >= self.max_len)

    def _sweep_in(self) -> bool:
        """Tick head shared by all slot schedulers: (0) abort
        client-cancelled slots — their pages return before admission;
        then (1) drain the intake fan-in into ALL free slots (binding
        them RESERVED) before any device work; then (2) for the
        monolithic-prefill schedulers, prefill the newly bound slots.
        Under the chunked schedulers their first chunks ride the next
        dispatch instead.  Parked sequences compete with intake for every
        free slot, and under slot pressure a lower-priority decoding slot
        is preempted for more urgent queued work.  Returns True iff
        anything moved."""
        worked = False
        for slot in self.slots:
            req = slot.request
            if req is not None and req.fsm.state == states.REQUEST_CANCELLED:
                self._abort_slot(slot)
                worked = True
        for parked in list(self._parked):
            if parked.req.fsm.state == states.REQUEST_CANCELLED:
                self._discard_parked(parked)
                self._parked.remove(parked)
                worked = True
        was_idle = not any(s.request is not None for s in self.slots)
        newly: List[DecodeSlot] = []
        intake_dry = False
        for slot in self.slots:
            if slot.request is not None:
                continue
            # Parked sequences compete with intake for every free slot
            # (_try_resume arbitrates by effective class, with aging);
            # a dry intake never blocks later slots from resuming.
            if self._parked and self._try_resume(slot):
                worked = True
                continue
            if intake_dry:
                continue
            req = self._pop_next(slot)
            if req is None:
                intake_dry = True
                continue
            self._bind_slot(slot, req)
            newly.append(slot)
            worked = True
        if newly and was_idle:
            self.stats["batches"] += 1      # new busy period begins
        if self.scheduler not in ("slot_chunked", "slot_paged"):
            for slot in newly:
                self._prefill_slot(slot)
        # Slot-pressure preemption: every slot is busy but more urgent
        # work is waiting — swap the worst strictly-lower-priority
        # decoding slot out (its sequence parks, loses nothing) and bind
        # the urgent arrival in its place.  Only reachable under
        # slot_paged (the policy check pins preemption to it).
        if (self._ov is not None and self._ov.preemption
                and all(s.request is not None for s in self.slots)):
            while True:
                best = self.intake.highest_pending_class()
                if best is None:
                    break
                victim = self._choose_victim(best)
                if victim is None or not self._preempt_slot(victim):
                    break
                req = self._pop_next(victim)
                if req is None:
                    break       # shed/cancel drained it; victim resumes
                self._bind_slot(victim, req)
                worked = True
        return worked

    def _prefill_slot(self, slot: DecodeSlot) -> None:
        """Monolithic admission tail (``slot``/``slot_fused``): one B=1
        prefill dispatch (flash attention over the prompt), one dedicated
        host sync for the first token, and one copy of the B=1 cache into
        the batch-cache row — the serializing intermediary the chunked
        scheduler deletes.  Every active slot loses one decode-step
        opportunity while this runs (``admission_stall_steps``)."""
        self.stats["admission_stall_steps"] += sum(
            1 for s in self.slots
            if s is not slot and s.request is not None and s.generated > 0)
        prompt = torch.from_numpy(slot.prompt[None]).to(self.device)
        with torch.no_grad():
            tok, one = self.model.prefill(self.params, prompt, self.max_len)
        self.stats["prefills"] += 1
        self.stats["prefill_dispatches"] += 1
        self.stats["prefill_chunks"] += 1   # one whole-prompt chunk
        self.stats["host_syncs"] += 1       # the int(...) fetch below
        _write_slot_caches(self._dense_caches(), one, slot.index)
        self.stats["cache_copy_dispatches"] += 1
        # Honest copy accounting: the B=1 side cache is KV traffic this
        # scheduler pays to establish residency.
        self.pool.kv_copy_bytes += sum(t.numel() * t.element_size()
                                       for t in _cache_leaves(one))
        # ... -> ALLOCATED (KV materialized in this slot's cache rows).
        slot.fsm.transition(states.BUFFER_RESERVED, states.BUFFER_ALLOCATED)
        padded = len(slot.prompt)
        slot.next_tok = int(tok[0])
        slot.pos = padded
        slot.prefill_pos = padded
        self._pos[slot.index] = padded
        self._cur[slot.index] = slot.next_tok

    def tick(self) -> Tuple[int, bool]:
        """One engine iteration (micro-batch): abort cancelled slots,
        swap in, harvest + retire, then one *fused block* of K decode
        steps (``slot_fused``) or a single decode step (``slot``, the
        K=1 baseline); ``slot_chunked``/``slot_paged`` additionally
        stream one prompt chunk per admitting slot inside the same
        dispatch.  Returns (requests retired, did work).

        The whole dispatch runs under the tick watchdog: an exception —
        injected or organic — NEVER propagates out of ``tick()``.
        Transient faults earn ``tick_retries`` whole-tick retries; beyond
        that the bound slots fail with typed terminals and the engine
        keeps serving (``_on_tick_fault``).  When leases are armed,
        silent clients are reaped first; with ``snapshot_dir`` armed,
        the tick boundary is where snapshots are taken."""
        if self.dead is not None:
            return 0, False
        reaped = self._reap_leases() if self.lease_s is not None else False
        self._in_tick = True
        try:
            if self.scheduler in ("slot_chunked", "slot_paged"):
                served, worked = self._tick_chunked()
            elif self.scheduler == "slot_fused":
                served, worked = self._tick_fused()
            else:
                served, worked = self._tick_scalar()
            self._tick_failures = 0
        except Exception as exc:        # noqa: BLE001 — watchdog boundary
            served, worked = self._on_tick_fault(exc)
        finally:
            self._in_tick = False
        # Tick boundary: the one point where host state is consistent
        # (no half-harvested dispatch, no half-claimed admission), so the
        # one point snapshots are taken.
        self._ticks += 1
        if (self._snap_dir is not None and self.dead is None
                and (self._snap_requested
                     or (self._snap_every is not None
                         and self._ticks % self._snap_every == 0))):
            self._snap_requested = False
            with contextlib.suppress(Exception):
                self.save_snapshot()
        if self.faults is not None:
            self.stats["faults_injected"] = self.faults.n_fired
        return served, worked or reaped

    def _choose_k(self, active: List[DecodeSlot]) -> int:
        """Block length for this tick: never past the smallest remaining
        budget over active slots (a block ends exactly when the first
        budget-bounded sequence finishes), and at most ``k_free`` while a
        slot is FREE, so an arrival waits at most ``k_free`` steps."""
        k = min(self.k_max,
                min(s.request.max_tokens - s.generated for s in active))
        if len(active) < self.max_batch:
            k = min(k, self.k_free)
        return max(1, k)

    def _tick_fused(self) -> Tuple[int, bool]:
        """One packet-mode iteration: the exact-TTFT harvest of prefill
        tokens stays per-request, then ONE fused device call runs K decode
        steps for the whole slot pool and ONE device->host sync harvests
        the [B, K] token block."""
        served = 0
        worked = self._sweep_in()
        # Harvest each fresh admission's prefill token NOW, at K=1 — TTFT
        # stays exact; sequences done after one token retire here.
        for slot in self.slots:
            req = slot.request
            if req is None or slot.generated > 0:
                continue
            tok = int(slot.next_tok)
            slot.outs[0] = tok
            slot.generated = 1
            now = time.monotonic()
            req.first_token_t = now
            req.token_ts.append(now)
            self._stream_tokens(req, 0, [tok])
            worked = True
            if self._finished(req, tok, slot.generated, slot.pos):
                self._retire(slot)
                served += 1
        active = [s for s in self.slots if s.request is not None]
        if not active:
            return served, worked
        k = self._choose_k(active)
        B = self.max_batch
        rem_v = np.zeros((B,), np.int32)
        eos_v = np.full((B,), -1, np.int32)
        for s in active:
            rem_v[s.index] = s.request.max_tokens - s.generated
            eos_v[s.index] = s.request.eos_id
        zeros = np.zeros((B,), np.int32)
        self._fault_raise("engine.dispatch")    # pre-device: retry is safe
        t0 = time.monotonic()
        _, blk = self._dispatch(None, zeros, zeros, self._pos.copy(), rem_v,
                                eos_v, k)
        self.stats["host_syncs"] += 1   # the ONE sync for the whole block
        t1 = time.monotonic()
        self._fault_raise("engine.sync", retryable=False)
        served += self._harvest_block(active, blk, k, t0, t1)
        return served, True

    def _tick_scalar(self) -> Tuple[int, bool]:
        """The unfused baseline (``scheduler="slot"``): one decode step
        and one host sync per tick."""
        served = 0
        worked = self._sweep_in()
        # Harvest the token each active slot produced (prefill or the
        # previous decode step); stream it; retire finished sequences.
        for slot in self.slots:
            req = slot.request
            if req is None:
                continue
            slot.outs[slot.generated] = slot.next_tok
            slot.generated += 1
            now = time.monotonic()
            if slot.generated == 1:
                req.first_token_t = now     # TTFT measurement point
            req.token_ts.append(now)
            self._stream_tokens(req, slot.generated - 1,
                                [int(slot.next_tok)])
            worked = True
            if self._finished(req, int(slot.next_tok), slot.generated,
                              slot.pos):
                self._retire(slot)
                served += 1
        # One decode step over the fixed-shape batch; idle rows are
        # masked by their own per-row position.
        active = [s for s in self.slots if s.request is not None]
        if active:
            self._fault_raise("engine.dispatch")
            dev = torch.from_numpy(np.stack([self._cur, self._pos],
                                            axis=1)).to(self.device)
            with torch.no_grad():
                nxt, _ = self.model.decode_step(
                    self.params, self._dense_caches(), dev[:, :1],
                    dev[:, 1])
            cur = nxt.cpu().numpy()
            self.stats["host_syncs"] += 1   # one sync per decode step
            self._fault_raise("engine.sync", retryable=False)
            for s in active:
                s.next_tok = int(cur[s.index])
                s.pos += 1
                self._pos[s.index] = s.pos
                self._cur[s.index] = s.next_tok
                self.pool.note_tokens(s.request.req_id, s.pos)
            self.stats["decode_steps"] += 1
            self.stats["slot_busy_steps"] += len(active)
            worked = True
        return served, worked

    def _tick_chunked(self) -> Tuple[int, bool]:
        """One chunked-admission iteration: every slot whose prompt is
        still streaming contributes its next fixed-shape chunk, every
        decoding slot its next K steps, and BOTH ride ONE model dispatch
        and ONE host fetch.  ``slot_paged`` shares this tick verbatim;
        only the cache operand differs (the page pool + block table
        instead of the dense ring)."""
        served = 0
        worked = self._sweep_in()
        B, C = self.max_batch, self.chunk_tokens
        # Assemble this dispatch's chunk rows.  The page reservation is
        # extended to cover exactly the positions this chunk will
        # materialize (plus the decode budget with the final chunk)
        # BEFORE any device work, so pool exhaustion aborts cleanly.
        chunk = np.zeros((B, C), np.int32)
        start_v = np.zeros((B,), np.int32)
        nval_v = np.zeros((B,), np.int32)
        chunks: List[Tuple[DecodeSlot, int, bool]] = []
        for s in self.slots:
            if s.request is None or s.generated > 0:
                continue
            req = s.request
            n_rem = len(s.prompt) - s.prefill_pos
            v = min(C, n_rem)
            final = v == n_rem
            need = (len(s.prompt) + req.max_tokens if final
                    else s.prefill_pos + v)
            if not self._extend_with_preemption(s, need):
                self._reject_streaming(s)
                worked = True
                continue
            # Copy-on-write gate: this chunk writes [prefill_pos, need) —
            # any page there another holder can read is repointed to a
            # private copy BEFORE the block table is assembled.
            if (self.prefix_cache is not None and self.pool.ensure_private(
                    req.req_id, s.prefill_pos, need) != POOL_OK):
                self._reject_streaming(s)
                worked = True
                continue
            if (self.faults is not None
                    and self.faults.fire("pool.page_write") is not None):
                # Poisoned write: the pages this chunk would have written
                # are declared corrupted.  Quarantine pins them BEFORE
                # _fail_slot frees the sequence (the pin is the extra
                # refcount that survives the free), so they never
                # re-enter circulation.
                qp = self.pool.quarantine_range(req.req_id,
                                                s.prefill_pos, need)
                self.stats["pages_quarantined"] += len(qp)
                self._fail_slot(s, "poisoned page write "
                                   f"({len(qp)} pages quarantined)")
                worked = True
                continue
            chunk[s.index, :v] = s.prompt[s.prefill_pos:s.prefill_pos + v]
            start_v[s.index] = s.prefill_pos
            nval_v[s.index] = v
            chunks.append((s, v, final))
        active = [s for s in self.slots
                  if s.request is not None and s.generated > 0]
        if self.prefix_cache is not None and active:
            # Decode rows write [pos, pos + k): the fused block must
            # never write into a shared page, so the same gate runs here.
            still: List[DecodeSlot] = []
            for s in active:
                if self.pool.ensure_private(
                        s.request.req_id, s.pos,
                        s.pos + self.k_max) == POOL_OK:
                    still.append(s)
                else:           # CoW under total exhaustion: cancel whole
                    s.request.fsm.cas(states.REQUEST_RECEIVED,
                                      states.REQUEST_CANCELLED)
                    self._abort_slot(s)
                    worked = True
            active = still
        if not chunks and not active:
            return served, worked
        pos_v = self._pos.copy()
        for s, v, _ in chunks:
            # Streaming rows pass their POST-chunk extent: the decode
            # loop's idle-row position is the next *unwritten* slot.
            pos_v[s.index] = s.prefill_pos + v
        rem_v = np.zeros((B,), np.int32)
        eos_v = np.full((B,), -1, np.int32)
        for s in active:
            rem_v[s.index] = s.request.max_tokens - s.generated
            eos_v[s.index] = s.request.eos_id
        # Rows whose FINAL chunk rides this dispatch JOIN the decode
        # block immediately: rem is the budget minus the prefill token.
        for s, v, final in chunks:
            if final:
                rem_v[s.index] = s.request.max_tokens - 1
                eos_v[s.index] = s.request.eos_id
        # Adaptive K over everything that will decode this dispatch;
        # capped at k_free while a slot is FREE or a prompt is still
        # mid-stream, so arrivals and later chunks never wait behind a
        # long solo block.
        budgets = ([s.request.max_tokens - s.generated for s in active]
                   + [s.request.max_tokens - 1 for s, _, final in chunks
                      if final and s.request.max_tokens > 1])
        if budgets:
            k = min(self.k_max, min(budgets))
            if (any(s.request is None for s in self.slots)
                    or any(not final for _, _, final in chunks)):
                k = min(k, self.k_free)
            k = max(1, k)
        else:
            k = 0
        # ONE dispatch.  The dispatch probe sits here — after ALL host
        # bookkeeping, before any device work — so a retried tick
        # reassembles idempotently (extend claims 0 new pages,
        # ensure_private finds nothing shared) and redispatches the
        # identical work.
        self._fault_raise("engine.dispatch")
        t0 = time.monotonic()
        tok_pf, blk = self._dispatch(chunk if chunks else None, start_v,
                                     nval_v, pos_v, rem_v, eos_v, k)
        self.stats["host_syncs"] += 1   # ONE fetch covers chunk AND block
        if chunks:
            self.stats["prefills"] += 1
            self.stats["prefill_dispatches"] += 1
        t1 = time.monotonic()
        # Sync "timeout": the device advanced but the host never
        # harvested — a retry would re-decode past the recorded state, so
        # this one is non-retryable: the watchdog fails the slots.
        self._fault_raise("engine.sync", retryable=False)
        # Harvest chunks.  A final chunk delivers the prefill's first
        # token from the same fetch, flips the slot ALLOCATED, and — when
        # the dispatch carried a decode block — the row's first K decode
        # tokens are already in it (it joined on device).
        joined: List[DecodeSlot] = []
        for s, v, final in chunks:
            req = s.request
            s.prefill_pos += v
            self.stats["prefill_chunks"] += 1
            self._maybe_insert_prefixes(s)
            if not final:
                self.pool.note_tokens(req.req_id, s.prefill_pos)
                continue
            tok = int(tok_pf[s.index])
            s.fsm.transition(states.BUFFER_RESERVED,
                             states.BUFFER_ALLOCATED)
            s.pos = s.prefill_pos
            self._pos[s.index] = s.pos
            self._cur[s.index] = tok
            s.outs[0] = tok
            s.generated = 1
            ts0 = (t0 + (t1 - t0) / (k + 1)) if k else time.monotonic()
            req.first_token_t = ts0
            req.token_ts.append(ts0)
            self.pool.note_tokens(req.req_id, s.pos)
            self._stream_tokens(req, 0, [tok])
            if self._finished(req, tok, s.generated, s.pos):
                # Done at the prefill token: the device's initial
                # liveness mask kept this row out of the block.
                self._retire(s)
                served += 1
            elif k:
                joined.append(s)
        if k:
            served += self._harvest_block(active + joined, blk, k, t0, t1,
                                          joined=tuple(joined))
        return served, True

    def _dispatch(self, chunk: Optional[np.ndarray], start_v, nval_v,
                  pos_v, rem_v, eos_v, k: int):
        """ONE model call for this tick, its host inputs packed into one
        int32 upload and its outputs (the chunk's next tokens and the
        [B, k] block) fetched back in ONE ``.cpu()``.  The cache operand
        is the page pool + this dispatch's block table (``slot_paged``)
        or the dense batch cache.  Returns numpy (tok_pf [B] or None,
        block [B, k] int64 or None)."""
        B = self.max_batch
        C = 0 if chunk is None else chunk.shape[1]
        paged = self.scheduler == "slot_paged"
        bt = (self._block_table() if paged
              else np.zeros((B, 0), np.int32))
        host = np.concatenate(
            [bt, np.stack([self._cur, pos_v, rem_v, eos_v, start_v,
                           nval_v], axis=1)]
            + ([chunk] if chunk is not None else []), axis=1)
        dev = torch.from_numpy(host).to(self.device, non_blocking=False)
        P = bt.shape[1]
        block = dev[:, :P]
        cur, pos, rem, eos, start, nval = (dev[:, P + i] for i in range(6))
        caches = ({"pages_k": self.pool.store_k,
                   "pages_v": self.pool.store_v, "block": block}
                  if paged else self._dense_caches())
        m = self.model
        with torch.no_grad():
            if chunk is not None and k:
                tok, blk, _ = m.chunked_block(
                    self.params, caches, dev[:, P + 6:P + 6 + C], start,
                    nval, cur, pos, rem, eos, k=k, max_len=self.max_len)
                out = torch.cat([tok[:, None], blk], dim=1).cpu().numpy()
                return out[:, 0], out[:, 1:].astype(np.int64)
            if chunk is not None:
                tok, _ = m.prefill_chunk_into(
                    self.params, caches, dev[:, P + 6:P + 6 + C], start,
                    nval)
                return tok.cpu().numpy(), None
            blk, _ = m.decode_loop(self.params, caches, cur, pos, rem, eos,
                                   k=k, max_len=self.max_len)
            return None, blk.cpu().numpy().astype(np.int64)

    def _harvest_block(self, active: List[DecodeSlot], blk: np.ndarray,
                       k: int, t0: float, t1: float,
                       joined: Tuple[DecodeSlot, ...] = ()) -> int:
        """Harvest one fetched [B, K] token block: valid tokens form a
        per-row prefix (device masking stops emission at EOS/budget/
        max_len).  Rows in ``joined`` also produced their prefill token
        in this same dispatch, so their k+1 tokens share the
        interpolation window.  Returns requests retired."""
        served = 0
        for s in active:
            req = s.request
            s.fresh_resume = False      # a full block decoded: fair game
            row = blk[s.index]
            n_valid = int((row >= 0).sum())
            first_pos = s.generated
            nb = 1 if s in joined else 0
            for j in range(n_valid):
                s.outs[s.generated] = row[j]
                s.generated += 1
                # Per-token timestamps interpolated within the block.
                req.token_ts.append(
                    t0 + (j + 1 + nb) * (t1 - t0) / (k + nb))
            s.pos += n_valid
            self._pos[s.index] = s.pos
            self._cur[s.index] = int(row[n_valid - 1])
            # ONE page-accounting call per block.
            self.pool.note_tokens(req.req_id, s.pos)
            if s.pending_prefix:
                self._maybe_insert_prefixes(s)
            # ONE stream-ring burst per block per request.
            self._stream_tokens(req, first_pos, row[:n_valid])
            self.stats["slot_busy_steps"] += n_valid
            last = int(row[n_valid - 1])
            if n_valid < k or self._finished(req, last, s.generated, s.pos):
                self._retire(s)
                served += 1
        self.stats["decode_steps"] += k
        self.stats["fused_blocks"] += 1
        return served

    def occupancy(self) -> float:
        """Mean fraction of decode slots doing useful work per step."""
        steps = self.stats["decode_steps"]
        return (self.stats["slot_busy_steps"] / (steps * self.max_batch)
                if steps else 0.0)

    # ===========================================================================
    # Wave scheduler (baseline): batch-level waves, kept for A/B benchmarks.
    # ===========================================================================
    def _take_batch(self, timeout_s: float = 0.05) -> List[Request]:
        """Greedy batcher: first request blocks briefly, rest drained
        free."""
        batch: List[Request] = []
        deadline = time.monotonic() + timeout_s
        backoff = transport.Backoff()
        while len(batch) < self.max_batch:
            status, req = self.intake.try_recv()
            if status == nbb.OK:
                backoff.reset()
                # admission control: KV pages for prompt + generation
                need = len(req.prompt) + req.max_tokens
                if self.pool.try_admit(req.req_id, need) != POOL_OK:
                    self._reject(req)
                    continue
                if not req.fsm.cas(states.REQUEST_VALID,
                                   states.REQUEST_RECEIVED):
                    self.pool.free(req.req_id)   # cancelled while queued
                    self._finish_cancelled(req)
                    continue
                batch.append(req)
            elif batch or time.monotonic() > deadline:
                break
            else:
                backoff.wait(status)
        return batch

    def _run_batch(self, batch: List[Request]) -> None:
        """One wave: a B-row prefill of the left-padded prompts, then
        lockstep decode at the shared position ``plen + step`` (the flash
        kernel over the ring prefix on CUDA), one host sync per step,
        until every row is done."""
        B = len(batch)
        plen = max(len(r.prompt) for r in batch)
        toks = np.zeros((B, plen), np.int32)
        for i, r in enumerate(batch):
            toks[i, plen - len(r.prompt):] = r.prompt   # left-pad
        with torch.no_grad():
            cur, caches = self.model.prefill(
                self.params, torch.from_numpy(toks).to(self.device),
                self.max_len)
        self.stats["prefills"] += 1
        self.stats["prefill_dispatches"] += 1
        self.stats["prefill_chunks"] += B   # one whole-prompt chunk each

        max_new = max(r.max_tokens for r in batch)
        outs = np.full((B, max_new), -1, np.int64)
        done = np.zeros((B,), bool)
        for step in range(max_new):
            outs[~done, step] = cur.cpu().numpy()[~done]
            self.stats["host_syncs"] += 1
            for i, r in enumerate(batch):
                if not done[i] and (outs[i, step] == r.eos_id
                                    or step + 1 >= r.max_tokens):
                    done[i] = True
            if done.all() or plen + step + 1 >= self.max_len:
                break
            with torch.no_grad():
                cur, caches = self.model.decode_step(
                    self.params, caches, cur[:, None], plen + step)
            self.stats["decode_steps"] += 1

        for i, r in enumerate(batch):
            r.tokens_out = outs[i][outs[i] >= 0].astype(np.int32)
            r.done_t = time.monotonic()
            # No streaming in the wave baseline: the first token reaches
            # the client with the whole response.
            r.first_token_t = r.done_t
            if r.fsm.cas(states.REQUEST_RECEIVED, states.REQUEST_COMPLETED):
                self.stats["served"] += 1
            else:
                self.stats["cancelled"] += 1
            self.pool.free(r.req_id)
            self._respond(r)
        self.stats["batches"] += 1

    # -- engine loop --------------------------------------------------------------
    def step(self) -> int:
        """Drain everything currently runnable; returns requests served.
        Wave scheduler: one batch.  Slot schedulers: tick until the slot
        pool and intake are both idle."""
        if self.scheduler == "wave":
            batch = self._take_batch()
            if not batch:
                return 0
            self._run_batch(batch)
            return len(batch)
        total = 0
        while True:
            served, worked = self.tick()
            total += served
            if not worked:
                return total

    # -- crash recovery ------------------------------------------------------
    def request_snapshot(self) -> None:
        """Ask the batcher thread to snapshot at its next tick boundary
        (safe from any thread, including a signal handler: one boolean
        store)."""
        self._snap_requested = True

    def _params_fingerprint(self) -> str:
        """A digest of the weights a snapshot's streams were decoded
        with: every leaf's name, shape and dtype, and 64 evenly spaced
        elements of it, fetched in ONE copy (computed once; serving
        never changes the params).  Checksumming every weight per
        snapshot would dwarf the snapshot itself; a restore onto other
        weights differs in the sampled elements."""
        if self._params_digest is None:
            leaves = []

            def walk(prefix, tree):
                if isinstance(tree, dict):
                    for key in sorted(tree):
                        walk(f"{prefix}/{key}", tree[key])
                elif isinstance(tree, (list, tuple)):
                    for i, v in enumerate(tree):
                        walk(f"{prefix}/{i}", v)
                elif torch.is_tensor(tree):
                    leaves.append((prefix, tree))

            walk("", self.params)
            h = hashlib.blake2b(digest_size=16)
            samples = []
            for name, t in leaves:
                h.update(f"{name}:{tuple(t.shape)}:{t.dtype};".encode())
                flat = t.detach().reshape(-1)
                step = max(1, flat.numel() // 64)
                samples.append(flat[::step][:64].float())
            if samples:
                h.update(torch.cat(samples).cpu().numpy().tobytes())
            self._params_digest = h.hexdigest()
        return self._params_digest

    def _config_fingerprint(self) -> Dict[str, object]:
        """The shape contract a snapshot restores onto: same model, same
        slot/pool geometry, same scheduler, and the same weights
        (:meth:`_params_fingerprint` — byte-identical resumption decodes
        with the params the snapshot's streams were decoded with).
        Asserted at restore — a snapshot is an image of THIS engine
        shape, not a migration format."""
        return {
            "arch": self.model.cfg.name,
            "vocab": self.model.cfg.vocab_size,
            "max_batch": self.max_batch, "max_len": self.max_len,
            "page_size": self.pool.page_size,
            "pool_pages": self.pool.n_pages,
            "chunk_tokens": self.chunk_tokens,
            "k_max": self.k_max, "k_free": self.k_free,
            "scheduler": self.scheduler,
            "n_clients": len(self._sessions),
            "prefix_cache": self.prefix_cache is not None,
            "kv_dtype": str(self.pool.k.dtype),
            "params": self._params_fingerprint(),
        }

    def _journal_bind(self, req: Request) -> None:
        """Journal append at BIND: prompt + decode parameters are the
        whole replay story — greedy decode is deterministic, so
        re-binding the same record yields the same tokens.  The
        ``journal.append`` fault site models a lost record: the request
        still serves in this life, but cannot be replayed after a crash
        (its handle finalizes as "lost across restart" on re-bind)."""
        if (self.faults is not None
                and self.faults.fire("journal.append") is not None):
            return                      # injected: record lost
        self._journal.append({
            "req_id": req.req_id, "client_id": req.client_id,
            "prompt": np.asarray(req.prompt, np.int32),
            "max_tokens": req.max_tokens, "eos_id": req.eos_id,
            "priority": req.priority, "slo_s": req.slo_s,
        })

    def snapshot(self) -> "snapshot_mod.EngineSnapshot":
        """Capture the crash-consistent engine image at the current tick
        boundary (batcher thread only; one host sync for the page
        gather).  Shared pages are captured once however many block
        tables point at them; prefix-cache entries are recorded by their
        chain keys and page lists — restore re-claims the same physical
        pages, it never copies per sequence."""
        if self.scheduler != "slot_paged":
            raise SnapshotError(
                f"snapshot() needs scheduler='slot_paged', "
                f"not {self.scheduler!r}")
        extra = (self.prefix_cache.resident_pages()
                 if self.prefix_cache is not None else ())
        pool_state = self.pool.snapshot_state(extra_pages=extra)
        self.stats["host_syncs"] += 1
        prefix_entries = []
        if self.prefix_cache is not None:
            for e in sorted(self.prefix_cache._entries.values(),
                            key=lambda e: e.tick):
                prefix_entries.append((e.key, e.n_tokens, list(e.pages)))
        slots = []
        for s in self.slots:
            if s.request is None:
                continue
            slots.append(snapshot_mod.SlotImage(
                index=s.index, fsm=s.fsm, request=s.request,
                cur_token=int(self._cur[s.index]), pos=s.pos,
                generated=s.generated, outs=s.outs, prompt=s.prompt,
                prefill_pos=s.prefill_pos, next_tok=s.next_tok,
                chunk_hashes=(list(s.chunk_hashes)
                              if s.chunk_hashes is not None else None),
                pending_prefix=list(s.pending_prefix),
                created_prefixes=list(s.created_prefixes),
                fresh_resume=s.fresh_resume))
        # Peek (never consume) the in-flight rings: intake-resident
        # submissions and undelivered terminals are exactly what a crash
        # at this boundary would strand.
        queued: List[Request] = []
        for c in range(len(self._sessions)):
            for ring in self._client_rings(c):
                queued.extend(snapshot_mod.peek_ring(ring))
        undelivered: Dict[int, List[Request]] = {}
        for c in range(len(self._sessions)):
            items = snapshot_mod.peek_ring(self._raw_ring(self.responses[c]))
            if items:
                undelivered[c] = list(items)
        return snapshot_mod.EngineSnapshot(
            config=self._config_fingerprint(),
            journal_seq=(self._journal.seq
                         if self._journal is not None else 0),
            next_req_id=next(self._id),     # burns one id: ids may skip,
            pool=pool_state,                # never collide across a restore
            prefix_entries=prefix_entries,
            slots=slots, cur=self._cur.copy(), pos=self._pos.copy(),
            parked=list(self._parked),
            deferred=[(r, list(k)) for r, k in self._deferred],
            queued=queued, undelivered=undelivered,
            stats=dict(self.stats))

    def save_snapshot(self) -> Optional[str]:
        """Capture + write to ``snapshot_dir``.  Returns the path, or
        None when snapshots are disarmed or the write was torn by an
        injected ``snapshot.write`` fault (the previous good snapshot
        survives either way — tmp + checksum + atomic rename)."""
        if self._snap_dir is None:
            return None
        snap = self.snapshot()
        path = snapshot_mod.write_snapshot(snap, self._snap_dir,
                                           faults=self.faults)
        self.stats["snapshots"] += 1
        if path is not None:
            self.stats["snapshot_bytes"] = os.path.getsize(path)
        return path

    def _reset_runtime(self) -> None:
        """Empty pre-admission state on the existing engine object:
        fresh rings (sessions survive — their handles re-bind), free
        slots, no parked/deferred/in-flight bookkeeping.  The pool and
        prefix cache are NOT reset here; restore_state rebuilds them
        wholesale (callers that give up entirely reset the pool too)."""
        n_clients = len(self._sessions)
        self.intake = (PriorityIntake(n_clients, self._ov,
                                      self._intake_depth)
                       if self._ov is not None else
                       MpscQueue(n_clients,
                                 capacity_per_producer=self._intake_depth))
        self.responses = [SpscQueue(self._intake_depth)
                          for _ in range(n_clients)]
        self.streams = [SpscQueue(self._stream_depth)
                        for _ in range(n_clients)]
        if self.faults is not None:
            self._wrap_rings()
        self.slots = [DecodeSlot(i) for i in range(self.max_batch)]
        self._cur[:] = 0
        self._pos[:] = 0
        self._caches = None
        self._parked = []
        self._deferred = []
        self._inflight = {}
        self._pending_bind = {}
        self._restore_queue.clear()
        self._restored_reqs = {}
        if self.prefix_cache is not None:
            # Entries drop without decref: the pool is rebuilt (or
            # reset) wholesale right after, counts and all.
            self.prefix_cache._entries.clear()
        self.dead = None
        self._stop.clear()
        self._tick_failures = 0
        self._reaped = set()
        self._ticks = 0
        self._snap_requested = False

    def restore(self, snap: Union["snapshot_mod.EngineSnapshot", str,
                                  os.PathLike]) -> Dict[str, object]:
        """Reconstruct the engine from a snapshot (object or file path)
        and resume decode mid-stream: pool pages re-claimed at their
        exact physical ids and refcounts, block tables verbatim, prefix
        cache re-adopted by key, bound/parked slots with their Figure-4
        FSMs and decode cursors, stranded intake re-queued, undelivered
        terminals re-sent, and journal records past the snapshot's
        high-water mark replayed as fresh submissions (deterministic:
        greedy decode).  All-or-nothing: any failure resets the engine
        empty and raises :class:`SnapshotError`; an injected
        ``snapshot.restore`` fault aborts before any mutation.  Runs on
        the engine thread, on the current stream: the pool's page writes
        are ordered after every dispatch already enqueued."""
        if isinstance(snap, (str, os.PathLike)):
            snap = snapshot_mod.read_snapshot(os.fspath(snap))
        self._fault_raise("snapshot.restore")
        fp = self._config_fingerprint()
        if snap.config != fp:
            diff = {k: (snap.config.get(k), fp.get(k))
                    for k in set(snap.config) | set(fp)
                    if snap.config.get(k) != fp.get(k)}
            raise SnapshotError(f"config mismatch, cannot restore: {diff}")
        try:
            with self._paused_plan():
                self._reset_runtime()
                self.pool.restore_state(snap.pool)
                if self.prefix_cache is not None:
                    for key, n_tok, pages in snap.prefix_entries:
                        self.prefix_cache._entries[key] = PrefixEntry(
                            key, n_tok, list(pages),
                            next(self.prefix_cache._clock))
                self._cur[:] = snap.cur
                self._pos[:] = snap.pos
                for img in snap.slots:
                    s = self.slots[img.index]
                    s.fsm = img.fsm
                    s.request = img.request
                    s.next_tok = img.next_tok
                    s.pos = img.pos
                    s.generated = img.generated
                    s.outs = img.outs
                    s.prompt = img.prompt
                    s.prefill_pos = img.prefill_pos
                    s.chunk_hashes = img.chunk_hashes
                    s.pending_prefix = list(img.pending_prefix)
                    s.created_prefixes = list(img.created_prefixes)
                    s.fresh_resume = img.fresh_resume
                    if img.chunk_hashes:
                        for h in img.chunk_hashes:
                            self._inflight[h] = self._inflight.get(h, 0) + 1
                    self._restored_reqs[img.request.req_id] = img.request
                self._parked = list(snap.parked)
                for p in self._parked:
                    self._restored_reqs[p.req.req_id] = p.req
                self._deferred = [(r, list(k)) for r, k in snap.deferred]
                for req, _ in self._deferred:
                    self._restored_reqs[req.req_id] = req
                now = time.monotonic()
                for req in snap.queued:
                    # The previous life's monotonic clock means nothing
                    # here; the queue wait restarts (SLO sheds must not
                    # fire on a stale cross-process timestamp).
                    req.submit_t = now
                    self._restore_queue.append(req)
                    self._restored_reqs[req.req_id] = req
                replayed = 0
                if self._journal is not None:
                    for rec in self._journal.records[snap.journal_seq:]:
                        if rec["req_id"] in self._restored_reqs:
                            continue    # bound from the snapshot's own
                        req = Request(  # queue after capture: not lost
                            rec["req_id"], rec["client_id"],
                            np.asarray(rec["prompt"], np.int32),
                            rec["max_tokens"], rec["eos_id"],
                            submit_t=now)
                        req.priority = req.eff_priority = rec["priority"]
                        req.slo_s = rec["slo_s"]
                        req.fsm.transition(states.REQUEST_FREE,
                                           states.REQUEST_VALID)
                        self._restore_queue.append(req)
                        self._restored_reqs[req.req_id] = req
                        replayed += 1
                redelivered = 0
                for c, reqs in snap.undelivered.items():
                    for req in reqs:
                        self._restored_reqs[req.req_id] = req
                        self._respond(req)
                        redelivered += 1
                max_seen = max(self._restored_reqs, default=-1)
                self._id = itertools.count(
                    max(snap.next_req_id, max_seen + 1))
        except SnapshotError:
            raise
        except Exception as exc:
            with contextlib.suppress(Exception):
                self._reset_runtime()
                self.pool.reset()
            raise SnapshotError(f"restore failed mid-rebuild: {exc!r}")
        self.stats = dict(snap.stats)
        self.stats["restores"] += 1
        self.stats["replayed_requests"] += replayed
        self.stats["restarts"] = self._restart_count
        self.restore_report = {
            "resumed": len(snap.slots) + len(snap.parked)
                       + len(snap.deferred) + len(snap.queued),
            "replayed": replayed,
            "redelivered": redelivered,
            "failed": 0,
        }
        return self.restore_report

    def restore_latest(self, retries: int = 8) -> Optional[Dict[str, object]]:
        """Restore from the newest *valid* snapshot in ``snapshot_dir``,
        retrying through injected ``snapshot.restore`` faults (finite
        plans go quiet).  None when no usable snapshot exists or every
        retry failed — the engine is then reset empty (pool included) so
        re-bound handles fail typed instead of hanging."""
        if self._snap_dir is None:
            return None
        for _ in range(max(1, retries)):
            snap, path = snapshot_mod.load_latest(self._snap_dir)
            if snap is None:
                return None
            try:
                report = self.restore(snap)
                report["path"] = path
                return report
            except (SnapshotError, faults_mod.InjectedFault):
                continue
        with contextlib.suppress(Exception):
            self._reset_runtime()
            self.pool.reset()
        return None

    def _restart_from_crash(self, exc: Exception) -> bool:
        """The in-process relaunch (``serve_forever(restart=True)``):
        attempt a final boundary snapshot, restore from the newest good
        one, re-bind every live session handle.  False => no usable
        snapshot or the restart budget is spent (the caller dies with
        typed terminals for everything)."""
        if self._restart_count >= 5:
            return False                # a deterministic crash loop must
        if not self._in_tick:           # not restart forever
            with contextlib.suppress(Exception):
                self.save_snapshot()
        report = self.restore_latest()
        if report is None:
            return False
        self._restart_count += 1
        self.stats["restarts"] = self._restart_count
        for sess in self._sessions:
            sess._rebind_restored()
        return True

    def serve_forever(self, restart: bool = False) -> None:
        """The engine loop, with a last-resort boundary: slot-scheduler
        ticks never raise (the watchdog), but if the loop itself crashes
        — wave scheduler, a bug in recovery — the engine dies CLEANLY:
        every outstanding request resolves with a typed FailedStatus
        instead of clients hanging on rings nobody will ever fill again.

        With ``restart=True`` (and ``snapshot_dir`` armed) a loop crash
        relaunches instead: final snapshot attempt, restore from the
        newest good snapshot, handles re-bound, loop resumed.  On a
        CLEAN stop the final state is snapshotted so a later process can
        restore it."""
        backoff = transport.Backoff()
        while not self._stop.is_set():
            try:
                if self.scheduler == "wave":
                    worked = self.step() > 0
                else:
                    _, worked = self.tick()
            except Exception as exc:    # noqa: BLE001 — death boundary
                if (not restart or self._snap_dir is None
                        or not self._restart_from_crash(exc)):
                    self._die(f"engine loop crashed: {exc!r}")
                    return
                backoff.reset()
                continue
            if worked:
                backoff.reset()
            else:
                backoff.wait(nbb.BUFFER_EMPTY)
        if self._snap_dir is not None and self.dead is None:
            # Graceful shutdown: park the final consistent state for a
            # later restore.  With work still in flight, _die does the
            # parking — its last-gasp snapshot captures the live slots /
            # parked / queued requests FIRST, then resolves every handle
            # with a typed terminal, so no client hangs on a stopped
            # engine.
            pending = (any(s.request is not None for s in self.slots)
                       or bool(self._parked) or bool(self._deferred)
                       or bool(self._restore_queue))
            if not pending:
                for c in range(len(self._sessions)):
                    if any(snapshot_mod.peek_ring(r)
                           for r in self._client_rings(c)):
                        pending = True
                        break
            if pending:
                self._die("engine stopped; state snapshotted for restore")
            else:
                with contextlib.suppress(Exception):
                    self.save_snapshot()

    def start(self) -> threading.Thread:
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        return t

    def stop(self) -> None:
        self._stop.set()

    # -- client-side receive -----------------------------------------------------
    def get_response(self, client_id: int, timeout_s: float = 30.0
                     ) -> Union[Request, TimeoutStatus, "FailedStatus"]:
        """Next terminal Request for this client (legacy whole-response
        surface): a wrapper over the session's pump.  Falsy
        TimeoutStatus on timeout; a falsy FailedStatus at once on a dead
        engine."""
        return self._sessions[client_id].next_response(timeout_s)
