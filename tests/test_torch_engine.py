"""Port counterpart of ``tests/test_serve.py``: the port's serving
engine and paged KV pool on the CPU (``device="cpu"``), on the SMOKE
model at float32 with the reference's weights (``smoke_pair``).

Each equivalence (fused = unfused, chunked = slot across chunk sizes)
is held within the port; at one chunk size per test the tokens are
also held to the reference engine's on the same weights, computed once
per module (``ref_tokens``).  The typed statuses, the EOS masking, the
cancel races and the page accounting are held to the reference's
values.
"""
import dataclasses
import threading

import numpy as np
import pytest

pytest.importorskip("torch")

from _torch_parity import smoke_pair  # noqa: E402
from repro.serve.engine import ServeEngine as RefEngine  # noqa: E402
from repro.serve.kv_cache import PagedKVPool as RefPagedKVPool  # noqa: E402
from repro_torch.core import states  # noqa: E402
from repro_torch.serve.engine import (OversizeStatus,  # noqa: E402
                                      ServeEngine, TimeoutStatus,
                                      pack_token_event, unpack_token_event)
from repro_torch.serve.kv_cache import OK, POOL_FULL, PagedKVPool  # noqa: E402


def _engine(model, params, **kw):
    return ServeEngine(model, params, device="cpu", **kw)


def _cpu_pool(*args, **kw):
    return PagedKVPool(*args, device="cpu", **kw)


def _occupancy(pool):
    """Pool stats minus the monotonic traffic counters (kv_copy_bytes,
    resident peak): the stable "pages not leaked" comparison."""
    s = pool.stats()
    s.pop("kv_copy_bytes")
    s.pop("kv_resident_bytes_peak")
    return s


# ---------------------------------------------------------------------------
# paged pool
# ---------------------------------------------------------------------------
def test_pool_concurrent_admission_lock_free():
    """Many threads racing for pages: exactly-once claims, no deadlock."""
    pool = PagedKVPool(64, page_size=1, n_layers=1, kv_heads=1, head_dim=2, device="cpu")
    results = []

    def worker(tid):
        got = pool.try_admit(tid, 4)   # 4 pages each
        results.append((tid, got))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(32)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    admitted = [tid for tid, s in results if s == OK]
    assert len(admitted) == 16          # 64 pages / 4 per seq
    # each admitted seq owns disjoint pages
    seen = set()
    for tid in admitted:
        pages = pool.table(tid).pages
        assert len(pages) == 4
        assert not (set(pages) & seen)
        seen |= set(pages)


# ---------------------------------------------------------------------------
# engine end-to-end
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def pair():
    return smoke_pair()


@pytest.fixture(scope="module")
def engine_setup(pair):
    cfg, _, _, model, params = pair
    return cfg, model, params


MIXED = [12, 2, 7, 2, 1, 9, 24, 3]      # mixed, forces adaptive K


@pytest.fixture(scope="module")
def ref_tokens(pair):
    """The reference engine's results on the same weights, computed once
    for the module: the mixed workload under ``slot_fused`` and under
    ``slot_chunked`` at chunk 4, the EOS workload under both (its EOS the
    reference's own first greedy token), the padded-tail workload at
    chunk 50, the per-chunk page extents and the partial outputs of the
    cancel tests."""
    cfg, jm, jp, _, _ = pair
    v = cfg.vocab_size
    out = {"fused": _run_workload(jm, jp, "slot_fused", MIXED, v,
                                  engine=RefEngine)[1],
           "chunked": _run_workload(jm, jp, "slot_chunked", MIXED, v,
                                    engine=RefEngine, chunk_tokens=4)[1]}
    eos = _run_workload(jm, jp, "slot_fused", [6], v,
                        engine=RefEngine)[1][0][0]
    out["eos"] = eos
    out["eos_fused"] = _run_workload(jm, jp, "slot_fused", [6, 17], v,
                                     eos_id=eos, engine=RefEngine)[1]
    out["eos_chunked"] = _run_workload(jm, jp, "slot_chunked", [6, 17], v,
                                       eos_id=eos, engine=RefEngine,
                                       chunk_tokens=4)[1]
    out["padded_tail"] = _serve_padded_tail(
        RefEngine, jm, jp, v, "slot_chunked", chunk_tokens=50)
    out["extents"] = _chunk_extents(RefEngine, jm, jp, v)[0]
    for sched, ticks in (("slot", 4), ("slot_fused", 3)):
        out[f"cancel_{sched}"] = _cancelled_after(RefEngine, jm, jp, v,
                                                  sched, ticks)
    return out


def test_engine_single_request(engine_setup):
    cfg, model, params = engine_setup
    eng = _engine(model, params, max_batch=2, max_len=32, n_clients=1)
    req = eng.submit(0, np.arange(5) % cfg.vocab_size, max_tokens=4)
    assert req is not None
    served = eng.step()
    assert served == 1
    resp = eng.get_response(0, timeout_s=10)
    assert resp is not None
    assert resp.fsm.state == states.REQUEST_COMPLETED
    assert resp.tokens_out.shape == (4,)
    assert ((resp.tokens_out >= 0) & (resp.tokens_out < cfg.vocab_size)).all()
    assert eng.pool.free_pages() == eng.pool.n_pages  # pages returned


def test_engine_batches_multiple_clients(engine_setup):
    cfg, model, params = engine_setup
    eng = _engine(model, params, max_batch=4, max_len=32, n_clients=3)
    reqs = [eng.submit(c, np.arange(3 + c) % cfg.vocab_size, max_tokens=3)
            for c in range(3)]
    assert all(r is not None for r in reqs)
    eng.step()
    assert eng.stats["served"] == 3
    assert eng.stats["batches"] == 1   # one fused batch
    for c in range(3):
        resp = eng.get_response(c, timeout_s=10)
        assert resp is not None and resp.client_id == c
        assert len(resp.tokens_out) == 3


def test_engine_eos_stops_early(engine_setup):
    cfg, model, params = engine_setup
    eng = _engine(model, params, max_batch=1, max_len=32, n_clients=1)
    # discover the greedy first token, then use it as EOS
    eng.submit(0, np.arange(4) % cfg.vocab_size, max_tokens=6)
    eng.step()
    first = eng.get_response(0, timeout_s=10).tokens_out[0]
    eng.submit(0, np.arange(4) % cfg.vocab_size, max_tokens=6,
               eos_id=int(first))
    eng.step()
    resp = eng.get_response(0, timeout_s=10)
    assert len(resp.tokens_out) == 1           # stopped at EOS immediately


def test_engine_rejects_when_pool_full(engine_setup):
    cfg, model, params = engine_setup
    eng = _engine(model, params, max_batch=2, max_len=32, n_clients=1,
                      pool_pages=2, page_size=4)   # 8 tokens of KV total
    eng.submit(0, np.arange(6) % cfg.vocab_size, max_tokens=8)
    eng.step()
    resp = eng.get_response(0, timeout_s=10)
    assert resp.fsm.state == states.REQUEST_CANCELLED
    assert eng.stats["rejected"] == 1
    assert eng.pool.free_pages() == 2          # nothing leaked


def test_slot_engine_mixed_lengths_no_convoy(engine_setup):
    """Iteration-level batching: short requests flow through a slot while
    a long generation keeps decoding — fewer decode steps than the wave
    scheduler's sum of per-wave maxima."""
    cfg, model, params = engine_setup
    eng = _engine(model, params, max_batch=2, max_len=64, n_clients=1,
                      pool_pages=256, scheduler="slot")
    lengths = [12, 2, 2, 2]            # long first: occupies slot 0
    for n in lengths:
        assert eng.submit(0, np.arange(4) % cfg.vocab_size,
                          max_tokens=n) is not None
    served = eng.step()
    assert served == 4
    # Wave scheduling would convoy: waves [12,2] + [2,2] = 14+ steps.
    # Slot swap: the long sequence bounds the busy period (~12 steps).
    assert eng.stats["decode_steps"] < 14, eng.stats
    assert eng.stats["served"] == 4 and eng.stats["rejected"] == 0
    got = sorted(len(eng.get_response(0, 10).tokens_out) for _ in range(4))
    assert got == sorted(lengths)
    assert eng.pool.free_pages() == eng.pool.n_pages
    assert 0.0 < eng.occupancy() <= 1.0


def test_slot_engine_fifo_per_client(engine_setup):
    """Slot-swap batcher admits in per-client submission order: with one
    slot, responses complete strictly in FIFO order."""
    cfg, model, params = engine_setup
    eng = _engine(model, params, max_batch=1, max_len=32, n_clients=1,
                      pool_pages=256, scheduler="slot")
    ids = [eng.submit(0, np.arange(3) % cfg.vocab_size, max_tokens=2).req_id
           for _ in range(3)]
    eng.step()
    got = [eng.get_response(0, 10).req_id for _ in range(3)]
    assert got == ids, "per-client FIFO violated by slot batcher"


def test_slot_fsm_lifecycle_and_illegal_transitions(engine_setup):
    """Every slot ends a drained step FREE; driving a slot FSM through an
    illegal transition still raises (the Figure-4 cell is live)."""
    cfg, model, params = engine_setup
    eng = _engine(model, params, max_batch=2, max_len=32, n_clients=1,
                      pool_pages=256, scheduler="slot")
    eng.submit(0, np.arange(4) % cfg.vocab_size, max_tokens=2)
    eng.step()
    eng.get_response(0, 10)
    for slot in eng.slots:
        assert slot.fsm.state == states.BUFFER_FREE
        assert slot.request is None
    with pytest.raises(states.IllegalTransition):
        eng.slots[0].fsm.cas(states.BUFFER_FREE, states.BUFFER_RECEIVED)


def test_slot_engine_admits_while_decoding(engine_setup):
    """A request submitted mid-generation is swapped in without waiting
    for the running sequence to finish (no wave barrier)."""
    cfg, model, params = engine_setup
    eng = _engine(model, params, max_batch=2, max_len=64, n_clients=1,
                      pool_pages=256, scheduler="slot")
    eng.submit(0, np.arange(4) % cfg.vocab_size, max_tokens=10)
    # Run a few ticks: the long request is mid-decode.
    for _ in range(3):
        eng.tick()
    steps_before = eng.stats["decode_steps"]
    assert eng.slots[0].request is not None and steps_before >= 2
    eng.submit(0, np.arange(4) % cfg.vocab_size, max_tokens=2)
    served, _ = eng.tick()               # admission happens this tick...
    assert eng.slots[1].request is not None, "no mid-decode swap-in"
    assert eng.stats["batches"] == 1     # same busy period, no new wave
    while eng.stats["served"] < 2:       # ...and both run to completion
        eng.tick()
    # The short request overtakes the long one — the point of slot swap.
    lens = [len(eng.get_response(0, 10).tokens_out) for _ in range(2)]
    assert lens == [2, 10], lens
    assert eng.pool.free_pages() == eng.pool.n_pages


def test_wave_scheduler_still_available(engine_setup):
    """The wave baseline behind scheduler='wave' still serves correctly
    (it is the A/B baseline for benchmarks/bench_serve.py)."""
    cfg, model, params = engine_setup
    eng = _engine(model, params, max_batch=4, max_len=32, n_clients=2,
                      scheduler="wave")
    for c in range(2):
        assert eng.submit(c, np.arange(4) % cfg.vocab_size,
                          max_tokens=3) is not None
    assert eng.step() == 2
    assert eng.stats["batches"] == 1
    for c in range(2):
        resp = eng.get_response(c, timeout_s=10)
        assert resp is not None and len(resp.tokens_out) == 3


# ---------------------------------------------------------------------------
# streaming session API (handles, per-token delivery, cancel)
# ---------------------------------------------------------------------------
def test_token_event_wire_format_roundtrip():
    for rid, pos, tok in [(0, 0, 0), (7, 3, 121), (65535, 511, 2**31 - 1),
                          (65536, 0, 5)]:             # req_id wraps mod 2^16
        ev = pack_token_event(rid, pos, tok)
        assert isinstance(ev, int)                    # one scalar per step
        assert unpack_token_event(ev) == (rid & 0xFFFF, pos, tok)


def test_streaming_tokens_as_produced(engine_setup):
    """RequestHandle.tokens() delivers every output position exactly once,
    in order, and interleaves with decode (tokens arrive before the
    request is terminal when the engine runs concurrently)."""
    cfg, model, params = engine_setup
    eng = _engine(model, params, max_batch=2, max_len=64, n_clients=1,
                      pool_pages=256, scheduler="slot")
    eng_thread = eng.start()
    try:
        session = eng.connect(0)
        h = session.submit_i(np.arange(5) % cfg.vocab_size, max_tokens=8)
        got = list(h.tokens(timeout_s=60))
        assert [p for p, _ in got] == list(range(8))
        final = h.response
        assert final is not None
        assert final.fsm.state == states.REQUEST_COMPLETED
        assert [t for _, t in got] == list(final.tokens_out)
        assert final.first_token_t >= final.submit_t
        assert len(final.token_ts) == 8
    finally:
        eng.stop()
        eng_thread.join(timeout=10)
    assert eng.pool.free_pages() == eng.pool.n_pages


def test_streaming_two_interleaved_requests_demux(engine_setup):
    """Two in-flight requests on one session: the pump demultiplexes the
    shared stream ring by req_id; both handles see their own tokens."""
    cfg, model, params = engine_setup
    eng = _engine(model, params, max_batch=2, max_len=64, n_clients=1,
                      pool_pages=256, scheduler="slot")
    session = eng.connect(0)
    h1 = session.submit_i(np.arange(4) % cfg.vocab_size, max_tokens=6)
    h2 = session.submit_i(np.arange(6) % cfg.vocab_size, max_tokens=3)
    eng.step()                          # drive both to completion inline
    r1, r2 = h1.wait(timeout_s=10), h2.wait(timeout_s=10)
    assert r1 and r2
    assert [t for _, t in h1.tokens(timeout_s=10)] == list(r1.tokens_out)
    assert [t for _, t in h2.tokens(timeout_s=10)] == list(r2.tokens_out)
    assert len(r1.tokens_out) == 6 and len(r2.tokens_out) == 3


def _cancel_setup(engine, model, params, vocab, scheduler):
    """An engine with a 40-token request submitted on session 0 ->
    (engine, session, handle)."""
    eng = engine(model, params, max_batch=2, max_len=64, n_clients=1,
                 pool_pages=256, scheduler=scheduler)
    session = eng.connect(0)
    return eng, session, session.submit_i(np.arange(4) % vocab,
                                          max_tokens=40)


def _cancelled_after(engine, model, params, vocab, scheduler, ticks):
    """The partial output of the 40-token request cancelled after
    ``ticks`` inline ticks (the cancel tests' sequence)."""
    eng, _, h = _cancel_setup(engine, model, params, vocab, scheduler)
    for _ in range(ticks):
        eng.tick()
    h.cancel()
    eng.tick()
    return list(map(int, h.wait(timeout_s=10).tokens_out))


def test_cancel_mid_decode_frees_kv_and_keeps_batcher_alive(engine_setup, ref_tokens):
    """The acceptance property: cancel() mid-decode frees the slot's KV
    pages (pool stats return to baseline) without wedging the batcher."""
    cfg, model, params = engine_setup
    eng, session, h = _cancel_setup(_engine, model, params, cfg.vocab_size,
                                    "slot")
    baseline = _occupancy(eng.pool)
    for _ in range(4):
        eng.tick()                      # request is mid-decode
    assert eng.slots[0].request is not None
    assert eng.pool.used_pages() > 0
    assert h.cancel() is True
    assert h.cancel() is False          # exactly one winning proposal
    eng.tick()                          # abort sweep runs this tick
    assert _occupancy(eng.pool) == baseline, "KV pages not returned"
    assert eng.stats["cancelled"] == 1
    r = h.wait(timeout_s=10)
    assert r.fsm.state == states.REQUEST_CANCELLED
    assert 0 < len(r.tokens_out) < 40
    assert list(map(int, r.tokens_out)) == ref_tokens["cancel_slot"]   # partial output delivered
    # the batcher is not wedged: the next request runs to completion
    h2 = session.submit_i(np.arange(4) % cfg.vocab_size, max_tokens=3)
    eng.step()
    r2 = h2.wait(timeout_s=10)
    assert r2 and r2.fsm.state == states.REQUEST_COMPLETED
    assert _occupancy(eng.pool) == baseline
    for slot in eng.slots:
        assert slot.fsm.state == states.BUFFER_FREE


def test_cancel_while_queued_never_touches_a_slot(engine_setup):
    """cancel() before the batcher admits: the intake pop observes the
    lost CAS, no pages are claimed, the terminal is CANCELLED/empty."""
    cfg, model, params = engine_setup
    eng = _engine(model, params, max_batch=1, max_len=32, n_clients=1,
                      pool_pages=256, scheduler="slot")
    session = eng.connect(0)
    h = session.submit_i(np.arange(4) % cfg.vocab_size, max_tokens=4)
    assert h.submitted
    assert h.cancel() is True           # engine has not seen it yet
    eng.step()
    r = h.wait(timeout_s=10)
    assert r.fsm.state == states.REQUEST_CANCELLED
    assert len(r.tokens_out) == 0
    assert eng.stats["cancelled"] == 1 and eng.stats["served"] == 0
    assert eng.stats["prefills"] == 0   # never reached a slot
    assert eng.pool.free_pages() == eng.pool.n_pages


def test_cancel_vs_completion_race_is_single_terminal(engine_setup):
    """Client cancels at a random moment while the engine thread decodes:
    whatever interleaving happens, the request lands in exactly one
    terminal state, pages return to baseline, nothing deadlocks."""
    cfg, model, params = engine_setup
    eng = _engine(model, params, max_batch=2, max_len=64, n_clients=1,
                      pool_pages=256, scheduler="slot")
    eng_thread = eng.start()
    try:
        session = eng.connect(0)
        for i in range(6):
            h = session.submit_i(np.arange(4) % cfg.vocab_size,
                                 max_tokens=12)
            canceller = threading.Timer(0.002 * i, h.cancel)
            canceller.start()
            r = h.wait(timeout_s=60)
            canceller.join()
            assert r, "handle wait timed out"
            assert r.fsm.state in (states.REQUEST_COMPLETED,
                                   states.REQUEST_CANCELLED)
    finally:
        eng.stop()
        eng_thread.join(timeout=10)
    assert eng.pool.free_pages() == eng.pool.n_pages
    assert (eng.stats["served"] + eng.stats["cancelled"]
            + eng.stats["rejected"]) == 6


def test_get_response_timeout_is_typed(engine_setup, pair):
    """The timeout path returns a falsy TimeoutStatus carrying the last
    Table-1 status — not a bare raise, not an untyped None."""
    cfg, model, params = engine_setup
    eng = _engine(model, params, max_batch=1, max_len=32, n_clients=1)
    resp = eng.get_response(0, timeout_s=0.05)
    assert isinstance(resp, TimeoutStatus)
    assert not resp                     # falsy: `if not resp:` just works
    assert resp.waited_s == 0.05
    _, jm, jp, _, _ = pair
    ref = RefEngine(jm, jp, max_batch=1, max_len=32,
                    n_clients=1).get_response(0, timeout_s=0.05)
    assert dataclasses.asdict(resp) == dataclasses.asdict(ref)
    # after a real response the same call returns the Request
    assert eng.submit(0, np.arange(3) % cfg.vocab_size, max_tokens=2)
    eng.step()
    assert eng.get_response(0, timeout_s=10).fsm.state == \
        states.REQUEST_COMPLETED


def test_legacy_submit_is_a_session_wrapper(engine_setup):
    """submit()/get_response() still behave exactly as before, layered
    over Session.submit_i + detach (the blocking-over-handles rule)."""
    cfg, model, params = engine_setup
    eng = _engine(model, params, max_batch=2, max_len=32, n_clients=1)
    req = eng.submit(0, np.arange(5) % cfg.vocab_size, max_tokens=4)
    assert req is not None and req.fsm.state == states.REQUEST_VALID
    eng.step()
    resp = eng.get_response(0, timeout_s=10)
    assert resp is req                  # same object comes back
    assert resp.tokens_out.shape == (4,)


def test_submit_i_pending_on_full_intake_then_recovers(engine_setup):
    """A full intake ring leaves the submission handle PENDING instead of
    dropping it; the handle's own polling delivers it once the batcher
    drains, and the request still completes."""
    cfg, model, params = engine_setup
    eng = _engine(model, params, max_batch=1, max_len=32, n_clients=1,
                      pool_pages=256, intake_depth=2, scheduler="slot")
    session = eng.connect(0)
    hs = [session.submit_i(np.arange(3) % cfg.vocab_size, max_tokens=2)
          for _ in range(3)]
    assert [h.submitted for h in hs] == [True, True, False]
    eng.step()                          # drains the ring; slot serves all
    # polling the pending handle pushes the send through; engine thread
    # is inline here, so alternate pump and step
    for _ in range(20):
        if hs[2].test():
            break
        eng.step()
    rs = [h.wait(timeout_s=10) for h in hs]
    assert all(r and r.fsm.state == states.REQUEST_COMPLETED for r in rs)
    assert eng.stats["served"] == 3


# ---------------------------------------------------------------------------
# packet-mode fused decode (scheduler="slot_fused", the default)
# ---------------------------------------------------------------------------
def _run_workload(model, params, scheduler, lengths, vocab, eos_id=-1,
                  engine=_engine, **engine_kw):
    """Serve a fixed workload on the port (or on ``engine``, the
    reference's class); returns (engine, per-request sequences in
    submission order)."""
    eng = engine(model, params, max_batch=2, max_len=64, n_clients=1,
                 pool_pages=256, scheduler=scheduler, **engine_kw)
    rids = []
    for i, n in enumerate(lengths):
        r = eng.submit(0, (np.arange(4) + i) % vocab, max_tokens=n,
                       eos_id=eos_id)
        assert r is not None
        rids.append(r.req_id)
    while eng.stats["served"] + eng.stats["rejected"] < len(lengths):
        eng.step()
    got = {}
    for _ in range(len(lengths)):
        r = eng.get_response(0, timeout_s=10)
        assert r, "response timed out"
        got[r.req_id] = list(map(int, r.tokens_out))
    return eng, [got[r] for r in rids]


def test_fused_equals_unfused_token_sequences(engine_setup, ref_tokens):
    """The acceptance property: for a fixed seed the fused block decoder
    produces exactly the token sequences of the per-token slot path —
    packet mode changes the exchange granularity, never the tokens —
    and the reference engine's on the same weights."""
    cfg, model, params = engine_setup
    lengths = MIXED
    e_slot, s_slot = _run_workload(model, params, "slot", lengths,
                                   cfg.vocab_size)
    e_fused, s_fused = _run_workload(model, params, "slot_fused", lengths,
                                     cfg.vocab_size)
    assert s_fused == s_slot
    assert s_fused == ref_tokens["fused"]
    assert [len(s) for s in s_slot] == lengths
    assert e_fused.pool.free_pages() == e_fused.pool.n_pages
    # and the point of the exercise: fewer host syncs for the same tokens
    toks = sum(lengths)
    assert e_fused.stats["host_syncs"] < e_slot.stats["host_syncs"]
    assert e_fused.stats["fused_blocks"] > 0
    assert e_slot.stats["fused_blocks"] == 0
    # every non-prefill token is exactly one busy row-step of a block
    assert e_fused.stats["slot_busy_steps"] == toks - len(lengths)


def test_fused_eos_masking_matches_scalar(engine_setup, ref_tokens):
    """Per-row EOS masking inside the fused block: rows that emit their
    stop token mid-block stop exactly where the scalar path stops, and
    where the reference engine stops."""
    cfg, model, params = engine_setup
    # discover the greedy token stream, then use its value as EOS
    _, seqs = _run_workload(model, params, "slot_fused", [6], cfg.vocab_size)
    eos = seqs[0][0]
    assert eos == ref_tokens["eos"]
    e_slot, s_slot = _run_workload(model, params, "slot", [6, 17],
                                   cfg.vocab_size, eos_id=eos)
    e_fused, s_fused = _run_workload(model, params, "slot_fused", [6, 17],
                                     cfg.vocab_size, eos_id=eos)
    assert s_fused == s_slot
    assert s_fused == ref_tokens["eos_fused"]
    assert all(s[-1] == eos or len(s) in (6, 17) for s in s_fused)


def test_fused_block_amortizes_syncs_and_ring_ops(engine_setup):
    """A saturated pool of long generations decodes in K>=3 blocks: host
    syncs and stream-ring operations per token drop well below 1."""
    cfg, model, params = engine_setup
    eng, seqs = _run_workload(model, params, "slot_fused", [24, 24, 24, 24],
                              cfg.vocab_size)
    toks = sum(len(s) for s in seqs)
    assert toks == 96
    assert eng.stats["host_syncs"] / toks <= 0.35, eng.stats
    assert eng.stats["ring_ops"] / toks < 1.0, eng.stats
    assert eng.occupancy() > 0.5


def test_fused_streaming_delivers_every_position_once(engine_setup):
    """tokens() over the burst-filled stream ring: every output position
    exactly once, in order, with per-token timestamps covering the whole
    generation (interpolated inside blocks, exact at the first token)."""
    cfg, model, params = engine_setup
    eng = _engine(model, params, max_batch=2, max_len=64, n_clients=1,
                      pool_pages=256)          # slot_fused is the default
    assert eng.scheduler == "slot_fused"
    eng_thread = eng.start()
    try:
        h = eng.connect(0).submit_i(np.arange(5) % cfg.vocab_size,
                                    max_tokens=11)
        got = list(h.tokens(timeout_s=60))
        final = h.response
        assert [p for p, _ in got] == list(range(11))
        assert [t for _, t in got] == list(final.tokens_out)
        assert final.first_token_t >= final.submit_t
        assert len(final.token_ts) == 11
        assert final.token_ts == sorted(final.token_ts)   # monotone ITL
    finally:
        eng.stop()
        eng_thread.join(timeout=10)
    assert eng.pool.free_pages() == eng.pool.n_pages


def test_fused_cancel_mid_decode_bounded_by_one_block(engine_setup, ref_tokens):
    """cancel() against the fused batcher: the abort sweep runs at the
    next block boundary, KV pages return to baseline, and the batcher
    keeps serving."""
    cfg, model, params = engine_setup
    eng, session, h = _cancel_setup(_engine, model, params, cfg.vocab_size,
                                    "slot_fused")
    baseline = _occupancy(eng.pool)
    for _ in range(3):
        eng.tick()                      # request is mid-generation
    assert eng.slots[0].request is not None
    assert h.cancel() is True
    eng.tick()                          # abort sweep: next block boundary
    assert _occupancy(eng.pool) == baseline, "KV pages not returned"
    r = h.wait(timeout_s=10)
    assert r.fsm.state == states.REQUEST_CANCELLED
    assert 0 < len(r.tokens_out) < 40
    assert list(map(int, r.tokens_out)) == ref_tokens["cancel_slot_fused"]
    h2 = session.submit_i(np.arange(4) % cfg.vocab_size, max_tokens=3)
    eng.step()
    r2 = h2.wait(timeout_s=10)
    assert r2 and r2.fsm.state == states.REQUEST_COMPLETED
    assert _occupancy(eng.pool) == baseline


def test_note_tokens_per_block_matches_per_step():
    """Regression for block-batched page accounting: one idempotent
    note_tokens(seq, final) call per block leaves the pool in exactly
    the state the per-step path produced."""
    def drive(step_sizes, pool_cls=_cpu_pool):
        pool = pool_cls(16, page_size=4, n_layers=2, kv_heads=2,
                        head_dim=8)
        assert pool.try_admit(7, 20, slot=3) == OK
        n = 4                                   # prompt tokens
        pool.note_tokens(7, n)
        for k in step_sizes:
            n += k
            pool.note_tokens(7, n)              # one call per "block"
        return pool.stats(), n

    per_step, n1 = drive([1] * 12)              # the scalar path
    per_block, n2 = drive([2, 8, 1, 1])         # fused blocks, same total
    assert n1 == n2 == 16
    assert per_step == per_block
    assert per_step["per_slot"][3] == (5, 16, 20)   # pages, tokens, reserved
    assert per_block == drive([2, 8, 1, 1], RefPagedKVPool)[0]


# ---------------------------------------------------------------------------
# chunked zero-copy admission (scheduler="slot_chunked", DESIGN.md §9)
# ---------------------------------------------------------------------------
def test_chunked_equals_slot_across_chunk_sizes(engine_setup, ref_tokens):
    """The acceptance property: for every chunk size (1, 4, and a whole
    bucketed prompt) the chunked scheduler emits token sequences
    byte-identical to the scalar slot path AND the fused path — in-place
    chunk admission changes the exchange plan, never the tokens.  At
    chunk 4 the tokens are the reference engine's."""
    cfg, model, params = engine_setup
    lengths = MIXED
    e_slot, s_slot = _run_workload(model, params, "slot", lengths,
                                   cfg.vocab_size)
    _, s_fused = _run_workload(model, params, "slot_fused", lengths,
                               cfg.vocab_size)
    assert s_fused == s_slot
    for chunk in (1, 4, 8):                  # prompts bucket to 8
        e_c, s_c = _run_workload(model, params, "slot_chunked", lengths,
                                 cfg.vocab_size, chunk_tokens=chunk)
        assert s_c == s_slot, f"chunk_tokens={chunk} diverged"
        if chunk == 4:
            assert s_c == ref_tokens["chunked"]
        # Zero-copy: no B=1 side cache was ever copied into the batch
        # cache, and no dedicated per-admission sync was paid.
        assert e_c.stats["cache_copy_dispatches"] == 0
        assert e_c.stats["admission_stall_steps"] == 0
        assert e_c.pool.free_pages() == e_c.pool.n_pages
        # Dispatches carrying prefill work are bounded by the chunk
        # count: sum over admissions of ceil(padded / chunk).
        bound = sum(-(-8 // chunk) for _ in lengths)
        assert e_c.stats["prefill_dispatches"] <= bound
        assert e_c.stats["prefill_chunks"] == bound
    # The monolithic paths pay a copy dispatch and stall active slots.
    assert e_slot.stats["cache_copy_dispatches"] == len(lengths)
    assert e_slot.stats["admission_stall_steps"] > 0


def _serve_padded_tail(engine, model, params, vocab, scheduler, **kw):
    """A 48-token prompt and a 4-token one at max_len 96 on ``engine``
    (``_engine`` or the reference's class) -> token sequences."""
    eng = engine(model, params, max_batch=2, max_len=96, n_clients=1,
                 pool_pages=512, scheduler=scheduler, **kw)
    rids = []
    for i, (plen, mt) in enumerate([(48, 4), (4, 8)]):
        r = eng.submit(0, (np.arange(plen) + i) % vocab, max_tokens=mt)
        rids.append(r.req_id)
    while eng.stats["served"] < 2:
        eng.step()
    got = {}
    for _ in range(2):
        r = eng.get_response(0, timeout_s=10)
        got[r.req_id] = list(map(int, r.tokens_out))
    return [got[r] for r in rids]


def test_chunked_equivalence_when_padded_tail_wraps_ring(engine_setup,
                                                         ref_tokens):
    """Regression: a final chunk whose PADDED tail pushes start + chunk
    past the cache ring size must not bump the wrap epoch — validity and
    slot positions are computed from the true valid extent, so the
    chunk's queries still see the whole prompt."""
    cfg, model, params = engine_setup

    def serve(scheduler, **kw):
        return _serve_padded_tail(_engine, model, params, cfg.vocab_size,
                                  scheduler, **kw)

    base = serve("slot")
    # bucket(48) = 64; the final chunk starts at 50, and 50 + 50 > 96.
    at_50 = serve("slot_chunked", chunk_tokens=50)
    assert at_50 == base
    assert at_50 == ref_tokens["padded_tail"]
    assert serve("slot_chunked", chunk_tokens=96) == base


def test_wave_oversize_check_uses_raw_prompt_len(engine_setup):
    """Regression: the fail-fast footprint must not bucket for the wave
    scheduler — bucket(17)=32 would reject a 17-token prompt that wave
    (which pads only to the batch max) serves in full."""
    cfg, model, params = engine_setup
    eng = _engine(model, params, max_batch=2, max_len=32, n_clients=1,
                      scheduler="wave")
    req = eng.submit(0, np.arange(17) % cfg.vocab_size, max_tokens=8)
    assert req is not None and req.fsm.state == states.REQUEST_VALID
    eng.step()
    resp = eng.get_response(0, timeout_s=10)
    assert resp.fsm.state == states.REQUEST_COMPLETED
    assert len(resp.tokens_out) == 8
    assert len(eng.oversize_log) == 0


def test_chunked_eos_masking_matches_scalar(engine_setup, ref_tokens):
    """A row that joins the decode block in the same dispatch as its
    final chunk still stops exactly at EOS (the scan's initial liveness
    mask sees the on-device prefill token)."""
    cfg, model, params = engine_setup
    _, seqs = _run_workload(model, params, "slot_chunked", [6],
                            cfg.vocab_size, chunk_tokens=4)
    eos = seqs[0][0]
    assert eos == ref_tokens["eos"]
    _, s_slot = _run_workload(model, params, "slot", [6, 17],
                              cfg.vocab_size, eos_id=eos)
    _, s_c = _run_workload(model, params, "slot_chunked", [6, 17],
                           cfg.vocab_size, eos_id=eos, chunk_tokens=4)
    assert s_c == s_slot
    assert s_c == ref_tokens["eos_chunked"]


def test_chunked_long_prompt_does_not_stall_decode(engine_setup):
    """The interference property: while a long prompt streams in chunk
    by chunk, the already-active slot keeps decoding — at least one
    decode step lands in every chunk-carrying dispatch, and the stall
    counter stays at zero (the fused path stalls the active slot once
    per admission)."""
    cfg, model, params = engine_setup
    eng = _engine(model, params, max_batch=2, max_len=128, n_clients=1,
                      pool_pages=256, scheduler="slot_chunked",
                      chunk_tokens=4)
    eng.submit(0, np.arange(4) % cfg.vocab_size, max_tokens=60)
    while not any(s.generated > 0 for s in eng.slots):
        eng.tick()
    eng.submit(0, np.arange(33) % cfg.vocab_size, max_tokens=4)  # bucket 64
    eng.tick()                      # admission sweep binds the slot
    streamer = [s for s in eng.slots
                if s.request is not None and s.request.max_tokens == 4]
    assert streamer and streamer[0].prefill_pos > 0, "not streaming"
    active = [s for s in eng.slots
              if s.request is not None and s.request.max_tokens == 60][0]
    chunk_ticks = 0
    while streamer[0].generated == 0 and streamer[0].request is not None:
        before = active.generated
        eng.tick()
        chunk_ticks += 1
        assert active.generated >= before + 1, \
            "active slot stalled during a prefill chunk"
    assert chunk_ticks >= 10            # 64-token bucket in 4-token chunks
    assert eng.stats["admission_stall_steps"] == 0
    while eng.stats["served"] < 2:
        eng.tick()
    got = sorted(len(eng.get_response(0, 10).tokens_out) for _ in range(2))
    assert got == [4, 60]
    assert eng.pool.free_pages() == eng.pool.n_pages


def test_chunked_batched_multi_slot_admission_sweep(engine_setup):
    """A burst of arrivals from idle is drained into ALL free slots
    before the first dispatch: their first chunks share ONE device
    dispatch and ONE host sync, and the burst costs one busy-period
    stats bump, not one per request."""
    cfg, model, params = engine_setup
    eng = _engine(model, params, max_batch=4, max_len=64, n_clients=1,
                      pool_pages=256, scheduler="slot_chunked",
                      chunk_tokens=8)
    for i in range(4):
        assert eng.submit(0, (np.arange(4) + i) % cfg.vocab_size,
                          max_tokens=3) is not None
    eng.tick()
    assert eng.stats["admitted"] == 4
    assert eng.stats["batches"] == 1
    assert eng.stats["prefill_dispatches"] == 1     # 4 admissions, 1 dispatch
    assert eng.stats["prefill_chunks"] == 4
    assert eng.stats["host_syncs"] == 1
    while eng.stats["served"] < 4:
        eng.tick()
    for _ in range(4):
        assert len(eng.get_response(0, 10).tokens_out) == 3
    assert eng.pool.free_pages() == eng.pool.n_pages


def _chunk_extents(engine, model, params, vocab):
    """A 9-token prompt (bucket 16) streamed in 4-token chunks into a
    64-page pool of 4-token pages: after each tick until the first token,
    (prefill_pos, pages held, tokens reserved) -> (that list, the engine,
    the request)."""
    eng = engine(model, params, max_batch=1, max_len=128, n_clients=1,
                 pool_pages=64, page_size=4, scheduler="slot_chunked",
                 chunk_tokens=4)
    req = eng.submit(0, np.arange(9) % vocab, max_tokens=20)
    extents = []
    while eng.slots[0].generated == 0:
        eng.tick()
        assert eng.slots[0].request is not None
        t = eng.pool.table(req.req_id)
        extents.append((eng.slots[0].prefill_pos, len(t.pages),
                        t.n_reserved))
    return extents, eng


def test_chunked_page_accounting_per_chunk(engine_setup, ref_tokens):
    """Pages are claimed chunk by chunk as positions materialize: after
    every streaming tick the sequence holds exactly
    ``pages_needed(extent)`` pages, and the decode budget is reserved
    with the final chunk — tick by tick as in the reference engine."""
    cfg, model, params = engine_setup
    extents, eng = _chunk_extents(_engine, model, params, cfg.vocab_size)
    assert extents == ref_tokens["extents"]
    padded = 16                                     # bucket of 9
    mid = [e for e in extents if e[0] < padded]
    assert len(mid) == 3, extents                   # 16 tokens, 4-chunks
    for extent, pages, reserved in mid:
        assert pages == eng.pool.pages_needed(extent)
        assert reserved == max(4, extent)           # first-chunk floor
    final = [e for e in extents if e[0] == padded]
    assert final
    assert final[0][1] == eng.pool.pages_needed(padded + 20)
    assert final[0][2] == padded + 20               # decode budget reserved
    while eng.stats["served"] < 1:
        eng.tick()
    assert len(eng.get_response(0, 10).tokens_out) == 20
    assert eng.pool.free_pages() == eng.pool.n_pages


def test_extend_reservation_matches_upfront_admission():
    """Chunk-boundary page accounting against note_tokens: claiming the
    reservation incrementally (extend_reservation per chunk + one
    note_tokens per block) lands the pool in exactly the state the
    all-upfront try_admit + per-step note_tokens path produced."""
    def upfront(pool_cls=_cpu_pool):
        pool = pool_cls(32, page_size=4, n_layers=2, kv_heads=2,
                        head_dim=8)
        assert pool.try_admit(9, 24, slot=1) == OK  # 16 prompt + 8 decode
        n = 16
        pool.note_tokens(9, n)
        for _ in range(8):
            n += 1
            pool.note_tokens(9, n)
        return pool.stats(), n

    def chunked(pool_cls=_cpu_pool):
        pool = pool_cls(32, page_size=4, n_layers=2, kv_heads=2,
                        head_dim=8)
        assert pool.try_admit(9, 4, slot=1) == OK   # first chunk only
        for extent in (4, 8, 12):
            assert pool.extend_reservation(9, extent) == OK
            pool.note_tokens(9, extent)
        assert pool.extend_reservation(9, 24) == OK  # final chunk
        pool.note_tokens(9, 17)                      # prompt + first token
        for n in (19, 23, 24):                       # fused decode blocks
            pool.note_tokens(9, n)
        return pool.stats(), 24

    a, n1 = upfront()
    b, n2 = chunked()
    assert n1 == n2 and a == b
    assert a["per_slot"][1] == (6, 24, 24)      # pages, tokens, reserved
    assert b == chunked(RefPagedKVPool)[0]


def test_extend_reservation_rolls_back_on_pool_full():
    pool = PagedKVPool(4, page_size=4, n_layers=1, kv_heads=1, head_dim=2, device="cpu")
    assert pool.try_admit(1, 4) == OK               # 1 page
    assert pool.try_admit(2, 8) == OK               # 2 pages; 1 free
    assert pool.extend_reservation(1, 24) == POOL_FULL  # needs 5 more
    assert pool.free_pages() == 1                   # all-or-nothing
    assert len(pool.table(1).pages) == 1
    assert pool.extend_reservation(1, 8) == OK      # the last page fits
    assert pool.free_pages() == 0


def test_chunked_cancel_mid_stream_releases_reserved_slot(engine_setup):
    """cancel() while the prompt is still streaming: the RESERVED slot
    takes the direct RESERVED->FREE edge, pages return, the terminal is
    CANCELLED/empty, and the batcher keeps serving."""
    cfg, model, params = engine_setup
    eng = _engine(model, params, max_batch=2, max_len=128, n_clients=1,
                      pool_pages=256, scheduler="slot_chunked",
                      chunk_tokens=4)
    baseline = _occupancy(eng.pool)
    session = eng.connect(0)
    h1 = session.submit_i(np.arange(4) % cfg.vocab_size, max_tokens=20)
    for _ in range(3):
        eng.tick()
    h2 = session.submit_i(np.arange(40) % cfg.vocab_size, max_tokens=8)
    eng.tick()
    eng.tick()
    mid = [s for s in eng.slots
           if s.request is not None and s.generated == 0]
    assert mid and 0 < mid[0].prefill_pos < len(mid[0].prompt)
    assert h2.cancel() is True
    eng.tick()                          # abort sweep releases RESERVED slot
    r2 = h2.wait(timeout_s=10)
    assert r2.fsm.state == states.REQUEST_CANCELLED
    assert len(r2.tokens_out) == 0
    while eng.stats["served"] < 1:
        eng.tick()
    r1 = h1.wait(timeout_s=10)
    assert len(r1.tokens_out) == 20
    assert _occupancy(eng.pool) == baseline
    for slot in eng.slots:
        assert slot.fsm.state == states.BUFFER_FREE


def test_chunked_mid_stream_pool_exhaustion_rejects(engine_setup):
    """A long prompt that outgrows the pool mid-stream is rejected whole
    (all-or-nothing): pages roll back, the slot frees, the terminal is
    the standard rejection."""
    cfg, model, params = engine_setup
    eng = _engine(model, params, max_batch=2, max_len=128, n_clients=1,
                      pool_pages=4, page_size=4,   # 16 tokens of KV total
                      scheduler="slot_chunked", chunk_tokens=4)
    eng.submit(0, np.arange(30) % cfg.vocab_size, max_tokens=8)  # bucket 32
    eng.step()
    resp = eng.get_response(0, timeout_s=10)
    assert resp.fsm.state == states.REQUEST_CANCELLED
    assert eng.stats["rejected"] == 1
    assert eng.pool.free_pages() == eng.pool.n_pages
    for slot in eng.slots:
        assert slot.fsm.state == states.BUFFER_FREE
    # the batcher is not wedged
    eng.submit(0, np.arange(4) % cfg.vocab_size, max_tokens=2)
    eng.step()
    assert eng.get_response(0, 10).fsm.state == states.REQUEST_COMPLETED


def test_chunked_streaming_tokens_and_ttft(engine_setup):
    """The streaming surface over the chunked scheduler: every position
    exactly once, first_token_t set at the final chunk's harvest, and
    monotone per-token timestamps."""
    cfg, model, params = engine_setup
    eng = _engine(model, params, max_batch=2, max_len=64, n_clients=1,
                      pool_pages=256, scheduler="slot_chunked",
                      chunk_tokens=4)
    eng_thread = eng.start()
    try:
        h = eng.connect(0).submit_i(np.arange(5) % cfg.vocab_size,
                                    max_tokens=11)
        got = list(h.tokens(timeout_s=60))
        final = h.response
        assert [p for p, _ in got] == list(range(11))
        assert [t for _, t in got] == list(final.tokens_out)
        assert final.first_token_t >= final.submit_t
        assert len(final.token_ts) == 11
        assert final.token_ts == sorted(final.token_ts)
    finally:
        eng.stop()
        eng_thread.join(timeout=10)
    assert eng.pool.free_pages() == eng.pool.n_pages


# ---------------------------------------------------------------------------
# fail-fast oversize rejection at the session layer
# ---------------------------------------------------------------------------
def test_submit_oversized_fails_fast_with_typed_status(engine_setup, pair):
    """A request whose footprint can never fit max_len is refused at
    submit_i time: terminal handle, typed falsy OversizeStatus, no
    intake round-trip, no batcher work, no pages touched."""
    cfg, model, params = engine_setup
    eng = _engine(model, params, max_batch=2, max_len=32, n_clients=1)
    session = eng.connect(0)
    h = session.submit_i(np.arange(20) % cfg.vocab_size, max_tokens=16)
    assert h.done and not h.submitted
    assert isinstance(h.status, OversizeStatus) and not h.status
    assert h.status.padded_len == 32 and h.status.max_len == 32
    _, jm, jp, _, _ = pair
    ref = RefEngine(jm, jp, max_batch=2, max_len=32, n_clients=1).connect(
        0).submit_i(np.arange(20) % cfg.vocab_size, max_tokens=16)
    assert dataclasses.asdict(h.status) == dataclasses.asdict(ref.status)
    assert h.response.fsm.state == states.REQUEST_CANCELLED
    assert list(h.tokens()) == []
    assert h.wait(timeout_s=1) is h.response
    assert h.cancel() is False          # already terminal
    # no engine-side traffic of any kind
    assert len(eng.oversize_log) == 1
    assert eng.stats["admitted"] == 0 and eng.stats["prefills"] == 0
    assert eng.pool.free_pages() == eng.pool.n_pages
    _, worked = eng.tick()
    assert not worked                   # the batcher never saw it


def test_submit_oversized_legacy_surface(engine_setup):
    """The legacy submit()/get_response() pair still delivers exactly
    one terminal for an oversized request (routed locally, no ring)."""
    cfg, model, params = engine_setup
    for scheduler in ("slot_chunked", "slot_fused", "wave"):
        eng = _engine(model, params, max_batch=2, max_len=32,
                          n_clients=1, scheduler=scheduler)
        req = eng.submit(0, np.arange(30) % cfg.vocab_size, max_tokens=8)
        assert req is not None
        assert req.fsm.state == states.REQUEST_CANCELLED
        resp = eng.get_response(0, timeout_s=5)
        assert resp is req
        assert len(resp.tokens_out) == 0
        # an in-range request still completes afterwards
        assert eng.submit(0, np.arange(4) % cfg.vocab_size, max_tokens=2)
        eng.step()
        assert eng.get_response(0, 10).fsm.state == states.REQUEST_COMPLETED


def test_engine_threaded_clients(engine_setup):
    """Concurrent client threads + engine thread: all requests complete."""
    cfg, model, params = engine_setup
    eng = _engine(model, params, max_batch=4, max_len=32, n_clients=4,
                      pool_pages=256)
    eng_thread = eng.start()
    n_per_client = 3
    got = {c: [] for c in range(4)}

    def client(c):
        import time
        sent = 0
        while sent < n_per_client:
            if eng.submit(c, (np.arange(4) + c) % cfg.vocab_size,
                          max_tokens=2) is not None:
                sent += 1
            else:
                time.sleep(0.001)
        while len(got[c]) < n_per_client:
            r = eng.get_response(c, timeout_s=30)
            assert r, f"client {c} timed out: {r}"
            got[c].append(r)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    eng.stop()
    eng_thread.join(timeout=10)
    assert all(len(v) == n_per_client for v in got.values())
    assert eng.stats["served"] == 12
    assert eng.pool.free_pages() == eng.pool.n_pages
