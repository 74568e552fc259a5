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

Overload control, fault plans, leases and the tick watchdog, and
snapshot/restore of the JAX package's engine wait for later slices.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import threading
import time
from collections import deque
from typing import Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import nbb, states, transport
from repro_torch.core.host_queue import MpscQueue, SpscQueue
from repro_torch.models.model import prefix_chunk_hashes, resolve_device
from repro_torch.serve.kv_cache import OK as POOL_OK
from repro_torch.serve.kv_cache import PagedKVPool, PrefixCache

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
    # Typed terminal status (FailedStatus) carried back to the handle.
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
    request (its loop crashed), or the session was closed.  Falsy like
    :class:`TimeoutStatus`, with the human-readable ``reason`` attached;
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
        self._finalized: set = set()
        # Closed sessions refuse new submits with an already-terminal
        # FailedStatus handle.
        self.closed = False

    def submit_i(self, prompt: np.ndarray, max_tokens: int = 16,
                 eos_id: int = -1) -> RequestHandle:
        """Non-blocking submit: always returns a handle.  If the intake
        ring is full the submission stays PENDING and is retried by the
        handle's own polling (``test``/``wait``/``tokens``).

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
                continue
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

    def close(self) -> None:
        """Explicit teardown (idempotent): cancel every in-flight
        handle, pump once so already-delivered terminals land, then
        refuse further submits.  The engine reclaims the cancelled
        requests' slots and pages on its next tick."""
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


def _write_slot_caches(full: Dict[str, torch.Tensor],
                       one: Dict[str, torch.Tensor], slot: int) -> None:
    """Copy a B=1 prefilled dense cache into row ``slot`` of the batch
    cache, in place: the batch axis is axis 1 of the layer-stacked
    ``[L, B, size, Hkv, hd]`` rings."""
    for name, f in full.items():
        f[:, slot].copy_(one[name][:, 0])


class ServeEngine:
    def __init__(self, model, params, *, max_batch: int = 4,
                 max_len: int = 128, n_clients: int = 2,
                 pool_pages: int = 64, page_size: int = 16,
                 intake_depth: int = 32, stream_depth: int = 256,
                 scheduler: str = "slot_fused", k_max: int = 8,
                 k_free: int = 2, chunk_tokens: int = 16,
                 prefix_cache: bool = True, device=None):
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
        self.intake = MpscQueue(n_clients,
                                capacity_per_producer=intake_depth)
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
                      # Requests the engine itself terminated (dead loop).
                      "requests_failed": 0}
        # Append-only log of fail-fast oversize rejects (written by
        # client threads in submit_i; list.append is the atomic).
        self.oversize_log: List[int] = []
        # Set once by _die(): the engine can no longer make progress;
        # every receive surface observes it and resolves with a typed
        # falsy FailedStatus instead of hanging.
        self.dead: Optional[str] = None

    # -- client API (one thread per client) -------------------------------------
    def connect(self, client_id: int) -> Session:
        """The client's streaming session.  One per client: the session
        owns the consumer side of the client's response/stream rings, so
        all receive-side calls for a client must come from one thread.
        Connecting re-opens a closed session."""
        sess = self._sessions[client_id]
        sess.closed = False
        return sess

    def submit(self, client_id: int, prompt: np.ndarray,
               max_tokens: int = 16, eos_id: int = -1) -> Optional[Request]:
        """Non-blocking submit (legacy whole-response surface): a thin
        wrapper over ``Session.submit_i`` that detaches the handle, so
        the terminal Request is delivered through ``get_response``.
        None => intake ring full (caller retries)."""
        session = self._sessions[client_id]
        h = session.submit_i(prompt, max_tokens, eos_id)
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
        # closed session or dead engine, after a short timeout — nobody
        # drains that ring; record the drop so stats never overcount.
        self.stats["ring_ops"] += 1
        abandoned = (self.dead is not None
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
        if self._sessions[req.client_id].closed:
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

    def _fail(self, req: Request, reason: str,
              outs: Optional[np.ndarray] = None) -> None:
        """Engine-initiated terminal (dead loop): typed FailedStatus,
        partial output, ``requests_failed``."""
        req.status = FailedStatus(reason)
        if (req.fsm.cas(states.REQUEST_VALID, states.REQUEST_CANCELLED)
                or req.fsm.cas(states.REQUEST_RECEIVED,
                               states.REQUEST_CANCELLED)):
            self.stats["requests_failed"] += 1
        else:
            self.stats["cancelled"] += 1
        req.done_t = time.monotonic()
        req.tokens_out = (np.zeros((0,), np.int32) if outs is None
                          else outs.astype(np.int32))
        self._respond(req)

    def _die(self, reason: str) -> None:
        """Terminal engine failure (the loop itself crashed): record the
        cause, resolve EVERY outstanding request with a typed falsy
        terminal, and leave ``dead`` set so every receive surface
        returns immediately instead of hanging."""
        if self.dead is not None:
            return
        self.dead = reason
        self._stop.set()
        for slot in self.slots:
            if slot.request is not None:
                self._fail(slot.request, reason,
                           slot.outs[:slot.generated])
                self.pool.free(slot.request.req_id)
                slot.request = None
        for req, _ in self._deferred:
            self._fail(req, reason)
        self._deferred = []
        while True:
            status, req = self.intake.try_recv()
            if status != nbb.OK or req is None:
                break
            self._fail(req, reason)

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

    def _dense_caches(self) -> Dict[str, torch.Tensor]:
        """The persistent dense batch cache, allocated at first use."""
        if self._caches is None:
            self._caches = self.model.init_cache(self.max_batch,
                                                 self.max_len)
        return self._caches

    def dense_cache_bytes(self) -> int:
        """Footprint the dense [max_batch, max_len] batch cache occupies
        or WOULD occupy (computed from shapes; nothing is allocated): the
        baseline ``kv_resident_bytes`` is compared against."""
        cfg = self.model.cfg
        itemsize = torch.empty((), dtype=cfg.compute_dtype).element_size()
        W = cfg.sliding_window
        size = min(W, self.max_len) if W else self.max_len
        return (2 * cfg.num_layers * self.max_batch * size
                * max(cfg.num_kv_heads, 1) * (cfg.head_dim_ or 1) * itemsize)

    def _block_table(self) -> np.ndarray:
        """Assemble this dispatch's [max_batch, max_pages] block table
        from the pool's per-sequence page lists.  This int32 write IS
        the whole "swap-in": residency never moves KV bytes.  Rows of
        free slots stay 0 — their writes go to the sink page and their
        reads are of stale, finite slots whose outputs are discarded."""
        bt = np.zeros((self.max_batch, self._max_pages), np.int32)
        for s in self.slots:
            if s.request is not None:
                pages = self.pool.table(s.request.req_id).pages
                bt[s.index, :len(pages)] = pages
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
            elif self.pool.try_admit(req.req_id, need,
                                     slot=slot.index) != POOL_OK:
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
            status, req = self.intake.try_recv()
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
        dispatch instead.  Returns True iff anything moved."""
        worked = False
        for slot in self.slots:
            req = slot.request
            if req is not None and req.fsm.state == states.REQUEST_CANCELLED:
                self._abort_slot(slot)
                worked = True
        was_idle = not any(s.request is not None for s in self.slots)
        newly: List[DecodeSlot] = []
        for slot in self.slots:
            if slot.request is not None:
                continue
            req = self._pop_next(slot)
            if req is None:
                break
            self._bind_slot(slot, req)
            newly.append(slot)
            worked = True
        if newly and was_idle:
            self.stats["batches"] += 1      # new busy period begins
        if self.scheduler not in ("slot_chunked", "slot_paged"):
            for slot in newly:
                self._prefill_slot(slot)
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
                                       for t in one.values())
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
        dispatch.  Returns (requests retired, did work)."""
        if self.dead is not None:
            return 0, False
        if self.scheduler in ("slot_chunked", "slot_paged"):
            return self._tick_chunked()
        if self.scheduler == "slot_fused":
            return self._tick_fused()
        return self._tick_scalar()

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
        t0 = time.monotonic()
        _, blk = self._dispatch(None, zeros, zeros, self._pos.copy(), rem_v,
                                eos_v, k)
        self.stats["host_syncs"] += 1   # the ONE sync for the whole block
        t1 = time.monotonic()
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
            dev = torch.from_numpy(np.stack([self._cur, self._pos],
                                            axis=1)).to(self.device)
            with torch.no_grad():
                nxt, _ = self.model.decode_step(
                    self.params, self._dense_caches(), dev[:, :1],
                    dev[:, 1])
            cur = nxt.cpu().numpy()
            self.stats["host_syncs"] += 1   # one sync per decode step
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
            if self.pool.extend_reservation(req.req_id, need) != POOL_OK:
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
        t0 = time.monotonic()
        tok_pf, blk = self._dispatch(chunk if chunks else None, start_v,
                                     nval_v, pos_v, rem_v, eos_v, k)
        self.stats["host_syncs"] += 1   # ONE fetch covers chunk AND block
        if chunks:
            self.stats["prefills"] += 1
            self.stats["prefill_dispatches"] += 1
        t1 = time.monotonic()
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

    def serve_forever(self) -> None:
        """The engine loop.  If the loop itself crashes, the engine dies
        CLEANLY: every outstanding request resolves with a typed
        FailedStatus instead of clients hanging on rings nobody will
        ever fill again."""
        backoff = transport.Backoff()
        while not self._stop.is_set():
            try:
                if self.scheduler == "wave":
                    worked = self.step() > 0
                else:
                    _, worked = self.tick()
            except Exception as exc:    # noqa: BLE001 — death boundary
                self._die(f"engine loop crashed: {exc!r}")
                raise
            if worked:
                backoff.reset()
            else:
                backoff.wait(nbb.BUFFER_EMPTY)

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
        surface): a wrapper over the session's pump."""
        return self._sessions[client_id].next_response(timeout_s)
