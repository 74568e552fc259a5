"""The port's crash recovery: the snapshot file protocol (checksum,
torn-write fallback), the write-ahead intake journal, bfloat16 pages
carried as int16 bits, and the ``slot_paged`` engine killed at EVERY
tick boundary of a run and restored in a fresh engine from snapshot +
journal — every stream byte-identical to the uninterrupted port run and
equal to the JAX package's, also with a preempted sequence parked at the
snapshot.  Plus torn snapshots, a lost journal record, restore faults, a
config or weights mismatch, ``serve_forever(restart=True)``, a session's
close, reconnect and adoption on both engines, and the reference's
property that snapshot -> restore is the identity on the pool.  SMOKE
size, float32."""
import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

try:  # optional dev dependency (requirements-dev.txt); property tests
    from hypothesis import given, settings, strategies as st  # skip without it
except ImportError:
    given = settings = st = None

from _torch_parity import (drive, pool_clean, share_jit,  # noqa: E402
                           smoke_pair)
from repro.serve import overload as jov  # noqa: E402
from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.core.faults import FaultPlan, FaultRule  # noqa: E402
from repro_torch.serve import snapshot as snapshot_mod  # noqa: E402
from repro_torch.serve.engine import FailedStatus, ServeEngine  # noqa: E402
from repro_torch.serve.kv_cache import OK, PagedKVPool  # noqa: E402
from repro_torch.serve.overload import OverloadPolicy  # noqa: E402
from repro_torch.serve.snapshot import (EngineSnapshot,  # noqa: E402
                                        IntakeJournal, SnapshotError)

jax.config.update("jax_platform_name", "cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """SMOKE-sized ops gain nothing from intra-op threads, and with
    several test workers on one machine a thread pool per worker
    oversubscribes the cores; the worker's setting is restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    jcfg, jm, jp, tm, tp = smoke_pair(scale=3.0)
    donor = JaxEngine(jm, jp, **_kw())
    return jcfg, jm, jp, tm, tp, donor


def _kw(pool_pages=24, max_batch=2, **extra):
    return dict(max_batch=max_batch, max_len=64, n_clients=2,
                pool_pages=pool_pages, page_size=8, scheduler="slot_paged",
                k_max=4, chunk_tokens=16, tick_retries=1, **extra)


def _mk(pair, snapshot_dir=None, fault_plan=None, params=None, **kw):
    _, _, _, tm, tp, _ = pair
    return ServeEngine(tm, tp if params is None else params, device="cpu",
                       snapshot_dir=snapshot_dir, fault_plan=fault_plan,
                       **_kw(**kw))


def _mk_jax(pair, snapshot_dir=None, **kw):
    """The reference engine with the same knobs, sharing the donor's
    compiled functions."""
    _, jm, jp, _, _, donor = pair
    je = JaxEngine(jm, jp, snapshot_dir=snapshot_dir, **_kw(**kw))
    share_jit(je, donor)
    return je


def _submit(sessions, vocab, n=4, max_tokens=12, seed=3, priorities=None):
    rng = np.random.default_rng(seed)
    return [sessions[i % len(sessions)].submit_i(
                rng.integers(0, 1000, 6) % vocab, max_tokens=max_tokens,
                priority=None if priorities is None else priorities[i])
            for i in range(n)]


def _tokens(handles):
    return [list(map(int, h.response.tokens_out)) for h in handles]


# ---------------------------------------------------------------------------
# The snapshot layer itself
# ---------------------------------------------------------------------------
def _snap(tag=0):
    return EngineSnapshot(
        config={"tag": tag}, journal_seq=0, next_req_id=7,
        pool={"n_pages": 4}, prefix_entries=[], slots=[],
        cur=np.arange(2, dtype=np.int32), pos=np.zeros(2, np.int32),
        parked=[], deferred=[], queued=[], undelivered={},
        stats={"served": tag})


@pytest.mark.parametrize("damage", ["truncate", "bit_flip", "empty"])
def test_snapshot_file_rejects_damage(tmp_path, damage):
    path = snapshot_mod.write_snapshot(_snap(3), str(tmp_path))
    got = snapshot_mod.read_snapshot(path)
    assert got.config == {"tag": 3} and np.array_equal(got.cur, [0, 1])
    blob = bytearray(open(path, "rb").read())
    if damage == "truncate":
        blob = blob[:len(blob) // 2]
    elif damage == "bit_flip":
        blob[-1] ^= 0xFF
    else:
        blob = bytearray()
    with open(path, "wb") as f:
        f.write(bytes(blob))
    with pytest.raises(SnapshotError):
        snapshot_mod.read_snapshot(path)


def test_torn_write_falls_back_to_last_good(tmp_path):
    d = str(tmp_path)
    snapshot_mod.write_snapshot(_snap(1), d)
    good = snapshot_mod.write_snapshot(_snap(2), d)
    plan = FaultPlan([FaultRule("snapshot.write", nth=1)])
    assert snapshot_mod.write_snapshot(_snap(3), d, faults=plan) is None
    snap, path = snapshot_mod.load_latest(d)
    assert path == good and snap.config == {"tag": 2}
    assert snapshot_mod.load_latest(str(tmp_path / "no")) == (None, None)
    for i in range(10):
        snapshot_mod.write_snapshot(_snap(10 + i), d, keep=8)
    assert len([n for n in os.listdir(d) if n.endswith(".ckpt")]) == 8


def test_journal_replay_and_torn_tail(tmp_path):
    p = str(tmp_path / "sub" / "j.wal")
    j = IntakeJournal(p)
    for i in range(3):
        assert j.append({"req_id": i, "prompt": np.arange(i + 1)}) == i
    j.close()
    with open(p, "ab") as f:                    # a crash mid-append
        f.write(b"\x13\x00\x00\x00torn-record-garbag")
    j2 = IntakeJournal(p)
    assert j2.seq == 3 and np.array_equal(j2.records[2]["prompt"],
                                          np.arange(3))
    j2.append({"req_id": 3})
    j2.close()
    assert [r["req_id"] for r in IntakeJournal(p).records] == [0, 1, 2, 3]


def test_bf16_pages_travel_as_int16_bits():
    """A bfloat16 pool's snapshot image holds the int16 view of the
    pages' bits (numpy has no bfloat16 without ml_dtypes); restoring it
    gives back the same bits, pickled through the snapshot file."""
    pool = PagedKVPool(6, 4, 2, 2, 8, dtype=torch.bfloat16, device="cpu")
    assert pool.try_admit(1, 10) == OK
    pool.note_tokens(1, 10)
    pages = pool.table(1).pages
    g = torch.Generator().manual_seed(0)
    vals = torch.randn((len(pages),) + tuple(pool.k.shape[1:]), generator=g)
    pool.k[torch.tensor(pages)] = vals.to(torch.bfloat16)
    pool.v[torch.tensor(pages)] = (-vals).to(torch.bfloat16)
    state = pool.snapshot_state()
    assert state["k"].dtype == np.int16 and state["data_pages"] == pages
    want_k = pool.k[torch.tensor(pages)].view(torch.int16).numpy()
    assert np.array_equal(state["k"], want_k)
    import pickle
    state = pickle.loads(pickle.dumps(state))
    other = PagedKVPool(6, 4, 2, 2, 8, dtype=torch.bfloat16, device="cpu")
    other.restore_state(state)
    assert torch.equal(other.k.view(torch.int16), pool.k.view(torch.int16))
    assert torch.equal(other.v.view(torch.int16), pool.v.view(torch.int16))
    assert other.table(1).pages == pages
    assert other.free_pages() == pool.free_pages()


# ---------------------------------------------------------------------------
# Kill at every tick
# ---------------------------------------------------------------------------
def _workload(vocab, n=4, max_tokens=12, seed=3, priorities=None,
              late_after=None):
    """[(client, prompt, budget, priority, submit at tick)]: the last
    request arrives after ``late_after`` ticks when given, else all at
    tick 0."""
    rng = np.random.default_rng(seed)
    return [(i % 2, rng.integers(0, 1000, 6) % vocab, max_tokens,
             None if priorities is None else priorities[i],
             late_after if late_after is not None and i == n - 1 else 0)
            for i in range(n)]


def _serve(make, vocab, wl, kill_tick=None, remake=None):
    """Serve ``wl`` on ``make()``; with ``kill_tick``, snapshot after that
    tick, abandon the engine, restore ``remake()`` from disk, re-bind the
    sessions and finish there.  Returns (final engine, handles, ticks,
    sequences parked at the kill)."""
    eng = make()
    sessions = [eng.connect(c) for c in range(2)]
    items = _workload(vocab, **wl)
    handles = [None] * len(items)

    def submit_due(tick):
        for i, (c, prompt, n, pri, at) in enumerate(items):
            if handles[i] is None and at <= tick:
                handles[i] = sessions[c].submit_i(prompt, max_tokens=n,
                                                  priority=pri)
    submit_due(0)
    ticks, parked = 0, 0
    while not all(h is not None and h.test() for h in handles):
        ticks += 1
        assert ticks < 800
        eng.tick()
        if ticks == kill_tick:
            parked = len(eng._parked)
            assert eng.save_snapshot() is not None
            for sess in sessions:
                sess.pump()
            eng = remake()
            report = eng.restore_latest()
            assert report is not None and report["failed"] == 0
            sessions = [eng.connect(c, resume=sess)
                        for c, sess in enumerate(sessions)]
        submit_due(ticks)
    return eng, handles, ticks, parked


def _kill_sweep(pair, tmp_path, wl, jax_kw, **ekw):
    """The uninterrupted port run (equal to the reference's), then a kill
    at every one of its tick boundaries; returns (reference engine,
    port engine, sequences parked at each kill)."""
    vocab = pair[0].vocab_size
    je, jh, _, _ = _serve(lambda: _mk_jax(pair, **jax_kw), vocab, wl)
    te, th, ticks, _ = _serve(lambda: _mk(pair, **ekw), vocab, wl)
    ref = _tokens(th)
    assert ref == _tokens(jh)
    assert ticks >= 3 and len({t for s in ref for t in s}) > 4
    parked = []
    for t in range(1, ticks + 1):
        d = str(tmp_path / f"kill{t}")

        def make():
            return _mk(pair, snapshot_dir=d, **ekw)
        eng, handles, _, n_parked = _serve(make, vocab, wl, t, make)
        assert all(h.response.fsm.state.endswith("COMPLETED")
                   for h in handles), f"kill@{t}"
        assert _tokens(handles) == ref, f"kill@{t}"
        for h, want in zip(handles, ref):       # exactly once
            assert sorted(h.tokens(timeout_s=5)) == list(enumerate(want))
        assert eng.stats["restores"] == 1
        pool_clean(eng)
        parked.append(n_parked)
    return je, te, parked


def _run_port(pair, **wl):
    """The port's uninterrupted run of ``wl``: every request COMPLETED,
    the tokens equal to the reference engine's run; -> (tokens, ticks)."""
    vocab = pair[0].vocab_size
    eng, hs, ticks, _ = _serve(lambda: _mk(pair), vocab, wl)
    assert all(h.response.fsm.state.endswith("COMPLETED") for h in hs)
    _, jh, _, _ = _serve(lambda: _mk_jax(pair), vocab, wl)
    assert _tokens(hs) == _tokens(jh)
    return _tokens(hs), ticks


def test_kill_at_every_tick_resumes_byte_identical(pair, tmp_path):
    """``test_serve_recovery.py::test_every_boundary_resumes_byte_identical``:
    every request COMPLETED, streams equal to the uninterrupted run (and
    the reference's), each position delivered once, the pool clean."""
    _kill_sweep(pair, tmp_path, {}, {})


def test_kill_with_a_parked_sequence_resumes_byte_identical(pair, tmp_path):
    """Preemption parks a low-priority sequence: killed at every tick of
    that run, including ticks whose snapshot carries the parked
    sequence's SwapImage, the restored engine resumes it — streams equal
    the uninterrupted port run and the reference's."""
    wl = dict(n=3, max_tokens=16, priorities=[2, 2, 0], late_after=3)
    je, te, parked = _kill_sweep(
        pair, tmp_path, wl,
        dict(max_batch=2, pool_pages=12, overload=jov.OverloadPolicy()),
        max_batch=2, pool_pages=12, overload=OverloadPolicy())
    assert te.stats["preemptions"] == je.stats["preemptions"] >= 1
    assert any(parked), "no snapshot caught a parked sequence"


# ---------------------------------------------------------------------------
# Journal replay, torn snapshots, faults, mismatches
# ---------------------------------------------------------------------------
def test_binds_after_the_snapshot_replay_from_the_journal(pair, tmp_path):
    """``test_serve_recovery.py::
    test_binds_after_snapshot_replay_deterministically``: two binds after
    the snapshot replay from the journal; the tokens equal the
    uninterrupted run's, itself equal to the reference engine's."""
    ref, _ = _run_port(pair, n=4, max_tokens=8)
    d = str(tmp_path / "wal")
    eng = _mk(pair, snapshot_dir=d)
    sessions = [eng.connect(c) for c in range(2)]
    rng = np.random.default_rng(3)
    vocab = pair[0].vocab_size
    prompts = [rng.integers(0, 1000, 6) % vocab for _ in range(4)]
    handles = [sessions[i % 2].submit_i(prompts[i], max_tokens=8)
               for i in range(2)]
    for _ in range(2):
        eng.tick()
    assert eng.save_snapshot() is not None
    handles += [sessions[i % 2].submit_i(prompts[i], max_tokens=8)
                for i in range(2, 4)]
    while eng._journal.seq < 4:                 # both bound after it
        eng.tick()
    for s in sessions:
        s.pump()
    eng2 = _mk(pair, snapshot_dir=d)
    report = eng2.restore_latest()
    assert report is not None and report["replayed"] == 2
    sessions = [eng2.connect(c, resume=s) for c, s in enumerate(sessions)]
    drive(eng2, handles)
    assert _tokens(handles) == ref
    pool_clean(eng2)


def test_lost_journal_record_fails_typed(pair, tmp_path):
    """``test_serve_recovery.py::test_lost_journal_record_fails_typed_not_hangs``."""
    vocab = pair[0].vocab_size
    plan = FaultPlan([FaultRule("journal.append", nth=3)])
    d = str(tmp_path / "lost")
    eng = _mk(pair, snapshot_dir=d, fault_plan=plan)
    sessions = [eng.connect(c) for c in range(2)]
    handles = _submit(sessions, vocab, n=2, max_tokens=4)
    for _ in range(2):
        eng.tick()
    assert eng.save_snapshot() is not None
    h3 = sessions[0].submit_i(np.arange(6) % vocab, max_tokens=24)
    while not any(s.request is not None and s.request.req_id == h3.req_id
                  for s in eng.slots):
        eng.tick()
    assert eng._journal.seq == 2
    for s in sessions:
        s.pump()
    eng2 = _mk(pair, snapshot_dir=d, fault_plan=plan)
    assert eng2.restore_latest() is not None
    sessions = [eng2.connect(c, resume=s) for c, s in enumerate(sessions)]
    assert h3.test() and isinstance(h3.status, FailedStatus)
    assert not h3.status
    assert "lost across restart" in h3.status.reason
    drive(eng2, handles)
    assert all(h.response.fsm.state.endswith("COMPLETED") for h in handles)


def test_torn_snapshot_and_restore_faults(pair, tmp_path):
    """``test_serve_recovery.py::test_torn_write_never_corrupts_last_good``
    and ``test_restore_fault_retries_then_gives_up_typed``: the torn write
    leaves a file that reads as damaged, the newest good snapshot stays
    the one loaded, an unbounded restore fault gives up empty and a
    finite one is retried through; the tokens equal the uninterrupted
    run's (and the reference engine's)."""
    vocab = pair[0].vocab_size
    ref, _ = _run_port(pair, max_tokens=24)
    d = str(tmp_path / "torn")
    eng = _mk(pair, snapshot_dir=d,
              fault_plan=FaultPlan([FaultRule("snapshot.write", nth=2)]))
    sessions = [eng.connect(c) for c in range(2)]
    handles = _submit(sessions, vocab, max_tokens=24)
    for _ in range(3):
        eng.tick()
    good = eng.save_snapshot()
    for _ in range(2):
        eng.tick()
    assert good is not None and eng.save_snapshot() is None   # torn
    torn = [p for p in snapshot_mod._snap_paths(d) if p != good]
    assert torn, "the torn write must still have left a file"
    with pytest.raises(SnapshotError):
        snapshot_mod.read_snapshot(torn[0])
    assert snapshot_mod.load_latest(d)[1] == good
    for s in sessions:
        s.pump()
    # An unbounded restore fault: every retry aborts and the engine
    # gives up EMPTY; a finite one goes quiet and the retry succeeds.
    bad = _mk(pair, snapshot_dir=d, fault_plan=FaultPlan(
        [FaultRule("snapshot.restore", nth=1, times=10**6)]))
    assert bad.restore_latest(retries=3) is None
    assert bad.pool.n_seqs() == 0 and bad.pool.used_pages() == 0
    eng3 = _mk(pair, snapshot_dir=d, fault_plan=FaultPlan(
        [FaultRule("snapshot.restore", nth=1, times=2)]))
    assert eng3.restore_latest() is not None
    sessions = [eng3.connect(c, resume=s) for c, s in enumerate(sessions)]
    drive(eng3, handles)
    assert _tokens(handles) == ref
    pool_clean(eng3)


def test_config_or_weights_mismatch_refuses_restore(pair, tmp_path):
    """``test_serve_recovery.py::test_config_mismatch_refuses_restore``,
    and a weights mismatch, which the port's fingerprint adds."""
    d = str(tmp_path / "shape")
    eng = _mk(pair, snapshot_dir=d)
    eng.connect(0)
    assert eng.save_snapshot() is not None
    snap, _ = snapshot_mod.load_latest(d)
    with pytest.raises(SnapshotError, match="config mismatch.*pool_pages"):
        _mk(pair, snapshot_dir=d, pool_pages=12).restore(snap)
    _, _, _, tm, tp, _ = pair
    other = {k: v for k, v in tp.items()}
    other["final_norm"] = tp["final_norm"] + 1.0
    with pytest.raises(SnapshotError, match="params"):
        _mk(pair, snapshot_dir=d, params=other).restore(snap)
    assert _mk(pair, snapshot_dir=d).restore(snap)["resumed"] == 0


# ---------------------------------------------------------------------------
# serve_forever(restart=True)
# ---------------------------------------------------------------------------
def test_loop_crash_restores_and_finishes(pair, tmp_path):
    ref, _ = _run_port(pair)
    eng = _mk(pair, snapshot_dir=str(tmp_path / "loop"), snapshot_every=2)
    sessions = [eng.connect(c) for c in range(2)]
    orig_tick = eng.tick
    calls = {"n": 0}

    def crashing_tick():
        calls["n"] += 1
        if calls["n"] == 5:
            raise RuntimeError("injected loop crash")
        return orig_tick()
    eng.tick = crashing_tick
    t = threading.Thread(target=eng.serve_forever, kwargs={"restart": True},
                         daemon=True)
    t.start()
    handles = _submit(sessions, pair[0].vocab_size)
    deadline = time.monotonic() + 60
    while not all(h.test() for h in handles):
        assert time.monotonic() < deadline, "restarted engine wedged"
        time.sleep(0.005)
    eng.stop()
    t.join(timeout=10)
    assert not t.is_alive() and eng.dead is None
    assert eng.stats["restarts"] == 1
    assert _tokens(handles) == ref


def test_restart_budget_bounds_a_crash_loop(pair, tmp_path):
    """``test_serve_recovery.py::test_restart_budget_bounds_crash_loops``."""
    eng = _mk(pair, snapshot_dir=str(tmp_path / "budget"), snapshot_every=2)
    eng.connect(0)
    eng.tick()
    assert eng.save_snapshot() is not None
    eng.tick = lambda: (_ for _ in ()).throw(RuntimeError("crash"))
    t = threading.Thread(target=eng.serve_forever, kwargs={"restart": True},
                         daemon=True)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and eng.dead is not None
    assert eng.stats["restarts"] == 5


def test_terminal_redelivery_is_deduped(pair, tmp_path):
    d = str(tmp_path / "dedupe")
    eng = _mk(pair, snapshot_dir=d)
    sessions = [eng.connect(c) for c in range(2)]
    handles = _submit(sessions, pair[0].vocab_size, n=2, max_tokens=3)
    while not all(h.req.done_t for h in handles):
        eng.tick()
    assert eng.save_snapshot() is not None      # terminals still in-ring
    assert all(h.test() for h in handles)       # ... then received
    n_final = [len(s._finalized) for s in sessions]
    eng2 = _mk(pair, snapshot_dir=d)
    assert eng2.restore_latest()["redelivered"] == 2
    sessions = [eng2.connect(c, resume=s) for c, s in enumerate(sessions)]
    for s in sessions:
        s.pump()
    assert all(not s._completed for s in sessions)
    assert [len(s._finalized) for s in sessions] == n_final


# ---------------------------------------------------------------------------
# The restore report; session close, reconnect and adoption
# ---------------------------------------------------------------------------
def _both_engines(pair, tmp_path, **kw):
    """(label, make(dir)) for the port and the reference engine."""
    return [("port", lambda d: _mk(pair, snapshot_dir=d, **kw)),
            ("jax", lambda d: _mk_jax(pair, snapshot_dir=d, **kw))]


def test_restore_reports_resumed_work(pair, tmp_path):
    """Four ticks into four requests of 24 tokens, a snapshot restored in
    a fresh engine reports at least two resumed sequences and one
    restore, and every request completes: the report and the tokens
    equal the reference engine's on the same run."""
    vocab, res = pair[0].vocab_size, []
    for label, make in _both_engines(pair, tmp_path):
        d = str(tmp_path / label)
        eng = make(d)
        sessions = [eng.connect(c) for c in range(2)]
        handles = _submit(sessions, vocab, max_tokens=24)
        for _ in range(4):
            eng.tick()
        assert eng.save_snapshot() is not None
        eng2 = make(d)
        report = eng2.restore_latest()
        assert report is not None and report["resumed"] >= 2
        assert eng2.stats["restores"] == 1
        sessions = [eng2.connect(c, resume=s)
                    for c, s in enumerate(sessions)]
        drive(eng2, handles)
        assert all(h.response.fsm.state.endswith("COMPLETED")
                   for h in handles)
        res.append(({**report, "path": os.path.basename(report["path"])},
                    _tokens(handles)))
    assert res[0] == res[1]


def test_close_is_idempotent_and_reconnect_reopens(pair, tmp_path):
    """A second close is a no-op; connecting again reopens the same
    session, which serves a request to completion (the same tokens as the
    reference engine's)."""
    res = []
    for _, make in _both_engines(pair, tmp_path):
        eng = make(None)
        sess = eng.connect(0)
        sess.close()
        sess.close()                            # idempotent
        assert sess.closed
        again = eng.connect(0)
        assert again is sess and not again.closed
        h = again.submit_i(np.arange(4, dtype=np.int32), max_tokens=2)
        drive(eng, [h])
        assert h.response.fsm.state.endswith("COMPLETED")
        res.append(_tokens([h]))
    assert res[0] == res[1]


def test_adopt_is_idempotent_and_closes_donor(pair, tmp_path):
    """``connect(resume=old)`` after a restore closes the donor session
    and moves its live handle to the new one; closing the husk and a
    self-adoption are no-ops, and the request completes with the
    reference engine's tokens."""
    vocab, res = pair[0].vocab_size, []
    for label, make in _both_engines(pair, tmp_path):
        d = str(tmp_path / label)
        eng = make(d)
        old = eng.connect(0)
        h = old.submit_i(np.arange(4, dtype=np.int32) % vocab, max_tokens=24)
        for _ in range(2):
            eng.tick()
        assert eng.save_snapshot() is not None
        old.pump()
        eng2 = make(d)
        assert eng2.restore_latest() is not None
        new = eng2.connect(0, resume=old)
        assert old.closed and not new._handles.keys() - {h.req_id}
        assert h._session is new
        old.close()                             # closing the husk: no-op
        eng2.connect(0, resume=new)             # self-adopt: no-op
        assert not new.closed
        drive(eng2, [h])
        assert h.response.fsm.state.endswith("COMPLETED")
        res.append(_tokens([h]))
    assert res[0] == res[1]


# ---------------------------------------------------------------------------
# Property: the restored pool is exactly the captured pool
# ---------------------------------------------------------------------------
def _assert_state_equal(a, b, path=""):
    assert type(a) is type(b), f"{path}: {type(a)} != {type(b)}"
    if isinstance(a, dict):
        assert set(a) == set(b), f"{path}: keys {set(a) ^ set(b)}"
        for k in a:
            _assert_state_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), f"{path}: len {len(a)} != {len(b)}"
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_state_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b), \
            f"{path}: arrays differ"
    else:
        assert a == b, f"{path}: {a!r} != {b!r}"


def _pool_state(eng):
    extra = (eng.prefix_cache.resident_pages()
             if eng.prefix_cache is not None else ())
    return eng.pool.snapshot_state(extra_pages=extra)


if st is None:
    def test_hypothesis_roundtrip_property():
        pytest.importorskip("hypothesis")   # records the skip with reason
else:
    @given(n_requests=st.integers(1, 4), max_tokens=st.integers(2, 12),
           kill_tick=st.integers(1, 8), seed=st.integers(0, 2**16))
    @settings(max_examples=8, deadline=None)
    def test_restore_is_exact(pair, tmp_path_factory, n_requests, max_tokens,
                              kill_tick, seed):
        """The reference's property on the port: snapshot -> restore is
        the identity on the pool (refcounts, block tables, the free-page
        ledger, page bytes and the copy ledger come back exactly), and
        the resumed engine finishes with the uninterrupted run's tokens,
        which equal the reference engine's."""
        d = str(tmp_path_factory.mktemp("prop"))
        eng = _mk(pair, snapshot_dir=d)
        sessions = [eng.connect(c) for c in range(2)]
        handles = _submit(sessions, pair[0].vocab_size, n=n_requests,
                          max_tokens=max_tokens, seed=seed)
        for _ in range(kill_tick):
            if all(h.test() for h in handles):
                break
            eng.tick()
        snap = eng.snapshot()
        want = _pool_state(eng)
        eng2 = _mk(pair, snapshot_dir=d)
        eng2.restore(snap)
        _assert_state_equal(want, _pool_state(eng2), "pool")
        pool = eng2.pool
        assert pool.kv_copy_bytes == (pool.cow_copy_bytes
                                      + pool.swap_in_bytes
                                      + pool.swap_out_bytes)
        for s in sessions:
            s.pump()
        for c, s in enumerate(sessions):
            eng2.connect(c, resume=s)
        drive(eng2, handles)
        ref, _ = _run_port(pair, n=n_requests, max_tokens=max_tokens,
                           seed=seed)
        assert _tokens(handles) == ref
        pool_clean(eng2)
