"""The port's self-healing serve loop against the JAX package's, under
the same injected faults: the tick watchdog (a transient dispatch fault
retried invisibly, then typed per-slot terminals — never a raise out of
``tick()``), a sync fault not retried, poisoned writes quarantining their
pages, a refused preemption leaving its victim decoding, the engine's own
stalled stream ring rolled back, per-session leases, ``Session.close``
and a dead engine.  Then a seeded ``FaultPlan.sweep`` run on both
engines: equal terminals, survivors byte-identical to the run with no
fault, pool invariants exact after every plan; and the reference's own
50-plan sweep on the port's engine.  SMOKE size, float32."""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from _torch_parity import (drive, outcome, pool_clean, share_jit,  # noqa: E402
                           smoke_pair)
from repro.core import faults as jfaults  # noqa: E402
from repro.serve import overload as jov  # noqa: E402
from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.core import faults, states  # noqa: E402
from repro_torch.core.faults import FaultPlan, FaultRule  # noqa: E402
from repro_torch.serve.engine import FailedStatus, ServeEngine  # noqa: E402
from repro_torch.serve.overload import OverloadPolicy  # noqa: E402

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


COUNTERS = ("served", "cancelled", "rejected", "requests_failed",
            "faults_injected", "pages_quarantined", "preemptions",
            "resumes", "shed_requests", "host_syncs", "decode_steps")


@pytest.fixture(scope="module")
def pair():
    jcfg, jm, jp, tm, tp = smoke_pair(scale=3.0)
    donor = JaxEngine(jm, jp, **_kw())
    return jcfg, jm, jp, tm, tp, donor


def _kw(max_batch=2, pool_pages=24, n_clients=2, **extra):
    return dict(max_batch=max_batch, max_len=64, n_clients=n_clients,
                pool_pages=pool_pages, page_size=8, scheduler="slot_paged",
                k_max=4, chunk_tokens=16, **extra)


def _plan_pair(rules):
    """The same rules as a port plan and a reference plan."""
    return (FaultPlan([FaultRule(**r) for r in rules]),
            jfaults.FaultPlan([jfaults.FaultRule(**r) for r in rules]))


def _engines(pair, rules=None, overload=None, **kw):
    """(port engine, reference engine) with the same knobs and plan."""
    jcfg, jm, jp, tm, tp, donor = pair
    tplan, jplan = _plan_pair(rules) if rules is not None else (None, None)
    te = ServeEngine(tm, tp, device="cpu", fault_plan=tplan,
                     overload=overload, **_kw(**kw))
    jov_policy = (None if overload is None else
                  jov.OverloadPolicy(priorities=overload.priorities,
                                     preemption=overload.preemption))
    je = JaxEngine(jm, jp, fault_plan=jplan, overload=jov_policy,
                   **_kw(**kw))
    share_jit(je, donor)
    return te, je


def _stats(eng):
    return {k: eng.stats[k] for k in COUNTERS}


def _both(pair, scenario, rules=None, **kw):
    """Run ``scenario(engine) -> handles`` on both engines; assert equal
    terminals and counters; returns (port engine, port handles)."""
    te, je = _engines(pair, rules, **kw)
    th, jh = scenario(te), scenario(je)
    assert outcome(th) == outcome(jh)
    assert _stats(te) == _stats(je)
    if rules is not None:
        assert te.faults.fired == je.faults.fired
    return te, th


def _one(vocab, n=8, budget=8):
    def scenario(eng):
        h = eng.connect(0).submit_i(np.arange(n) % vocab, max_tokens=budget)
        drive(eng, [h])
        return [h]
    return scenario


def test_failed_status_and_knob_validation(pair):
    """``test_serve_faults.py::test_failed_status_is_falsy_with_reason``,
    ``test_ctor_validates_robustness_knobs`` and
    ``test_no_plan_means_no_fault_layer``."""
    s = FailedStatus("tick failed: boom")
    assert not s and s.reason == "tick failed: boom"
    _, _, _, tm, tp, _ = pair
    for bad in ({"lease_s": 0.0}, {"tick_retries": -1}):
        with pytest.raises(ValueError):
            ServeEngine(tm, tp, device="cpu", **_kw(**bad))
    eng = ServeEngine(tm, tp, device="cpu", **_kw())
    assert eng.faults is None and eng.pool.faults is None
    assert not hasattr(eng.streams[0], "plan")      # bare rings


def test_transient_dispatch_fault_is_invisible(pair):
    vocab = pair[0].vocab_size
    ref, ref_h = _both(pair, _one(vocab))
    te, th = _both(pair, _one(vocab),
                   [{"site": "engine.dispatch", "nth": 1, "times": 1}])
    assert te.faults.n_fired == 1 and te.stats["requests_failed"] == 0
    assert outcome(th) == outcome(ref_h)
    assert te.fault_report()["tick_failures"] == 1
    assert ref.fault_report()["tick_failures"] == 0
    pool_clean(te)


def test_retries_exhausted_fail_slots_and_keep_serving(pair):
    """``test_serve_faults.py::
    test_dispatch_retries_exhausted_fails_slots_keeps_serving``."""
    vocab = pair[0].vocab_size

    def scenario(eng):
        sess = eng.connect(0)
        h = sess.submit_i(np.arange(8) % vocab, max_tokens=8)
        drive(eng, [h])
        h2 = sess.submit_i(np.arange(8) % vocab, max_tokens=4)
        drive(eng, [h2])
        return [h, h2]
    te, (h, h2) = _both(pair, scenario,
                        [{"site": "engine.dispatch", "nth": 1, "times": 2}])
    assert h.response.fsm.state == states.REQUEST_CANCELLED
    assert isinstance(h.response.status, FailedStatus)
    assert "tick failed" in h.response.status.reason
    assert h2.response.fsm.state == states.REQUEST_COMPLETED
    assert te.dead is None and te.stats["requests_failed"] == 1
    pool_clean(te)


def test_sync_fault_is_not_retried(pair):
    """``test_serve_faults.py::test_sync_timeout_is_not_retried``."""
    vocab = pair[0].vocab_size
    te, (h,) = _both(pair, _one(vocab),
                     [{"site": "engine.sync", "nth": 1, "times": 1}],
                     tick_retries=10)
    assert isinstance(h.response.status, FailedStatus)
    assert te.faults.n_fired == 1 and te.stats["requests_failed"] == 1
    pool_clean(te)


def test_poisoned_write_quarantines_pages(pair):
    vocab = pair[0].vocab_size

    def scenario(eng):
        sess = eng.connect(0)
        h = sess.submit_i(np.arange(8) % vocab, max_tokens=8)
        drive(eng, [h])
        h2 = sess.submit_i(np.arange(8) % vocab, max_tokens=8)
        drive(eng, [h2])
        return [h, h2]
    te, je = _engines(pair, [{"site": "pool.page_write", "nth": 1}])
    th, jh = scenario(te), scenario(je)
    assert outcome(th) == outcome(jh)
    assert "poisoned" in th[0].response.status.reason
    assert te.pool.quarantined == je.pool.quarantined != set()
    assert te.stats["pages_quarantined"] == len(te.pool.quarantined)
    assert th[1].response.fsm.state == states.REQUEST_COMPLETED
    pool_clean(te)
    assert te.pool.used_pages() == len(te.pool.quarantined)


def test_preempt_fault_leaves_victim_decoding(pair):
    vocab = pair[0].vocab_size

    def scenario(eng):
        lo = eng.connect(0).submit_i(np.arange(8) % vocab, max_tokens=16,
                                     priority=2)
        hi = eng.connect(1).submit_i((np.arange(6) + 3) % vocab,
                                     max_tokens=4, priority=0)
        drive(eng, [lo, hi])
        return [lo, hi]
    te, th = _both(pair, scenario,
                   [{"site": "pool.swap_out", "nth": 1, "times": 99}],
                   overload=OverloadPolicy(), max_batch=1, pool_pages=5)
    assert [r[0] for r in outcome(th)] == [states.REQUEST_COMPLETED] * 2
    assert te.stats["preemptions"] == 0
    pool_clean(te)


def test_stalled_stream_producer_recovers(pair):
    vocab = pair[0].vocab_size

    def scenario(eng):
        sess = eng.connect(0)
        h = sess.submit_i(np.arange(8) % vocab, max_tokens=8)
        drive(eng, [h])
        assert not eng._raw_ring(eng.streams[0])._uc & 1   # rolled back
        h2 = sess.submit_i(np.arange(8) % vocab, max_tokens=6)
        drive(eng, [h2])
        return [h, h2]
    te, (h, h2) = _both(pair, scenario,
                        [{"site": "transport.stall", "nth": 1}])
    assert isinstance(h.response.status, FailedStatus)
    assert len(h2.response.tokens_out) == 6
    pool_clean(te)


# ---------------------------------------------------------------------------
# Leases (wall-clock driven: port only, with the reference's own checks)
# ---------------------------------------------------------------------------
def test_lease_reaps_silent_client(pair):
    vocab = pair[0].vocab_size
    te, _ = _engines(pair, lease_s=0.05)
    dead_sess, live_sess = te.connect(0), te.connect(1)
    h_bound = dead_sess.submit_i(np.arange(8) % vocab, max_tokens=32)
    te.tick()                                   # binds + starts decoding
    h_queued = dead_sess.submit_i(np.arange(8) % vocab, max_tokens=8)
    time.sleep(0.08)                            # the client goes silent
    h_live = live_sess.submit_i(np.arange(8) % vocab, max_tokens=4)
    for _ in range(200):
        te.tick()
        if h_live.test() and te.stats["leases_reaped"]:
            break
    assert te.stats["leases_reaped"] == 1
    assert te.stats["requests_failed"] == 2
    assert te.pool.n_seqs() == 0
    assert h_live.response.fsm.state == states.REQUEST_COMPLETED
    for h in (h_bound, h_queued):
        r = h.wait(timeout_s=5)
        assert r.fsm.state == states.REQUEST_CANCELLED
        assert "lease expired" in r.status.reason
    pool_clean(te)


def test_lease_renewed_by_pumping_client(pair):
    vocab = pair[0].vocab_size
    te, _ = _engines(pair, lease_s=0.05)
    h = te.connect(0).submit_i(np.arange(8) % vocab, max_tokens=8)
    ticks = 0
    while not h.test():                         # test() pumps: heartbeat
        time.sleep(0.002)
        te.tick()
        ticks += 1
        assert ticks < 800
    assert h.response.fsm.state == states.REQUEST_COMPLETED
    assert te.stats["leases_reaped"] == 0
    pool_clean(te)


def test_lease_recovers_stalled_intake_ring(pair):
    vocab = pair[0].vocab_size
    te, _ = _engines(pair, lease_s=0.05)
    sess = te.connect(0)
    ring = te.intake.producer(0)
    sess.submit_i(np.arange(8) % vocab, max_tokens=4)
    faults.stall_mid_burst(ring, [object()])    # died mid-reservation
    assert ring._uc & 1
    time.sleep(0.08)
    for _ in range(50):
        te.tick()
        if te.stats["leases_reaped"]:
            break
    assert not ring._uc & 1 and te.stats["leases_reaped"] == 1
    h = te.connect(0).submit_i(np.arange(8) % vocab, max_tokens=4)
    drive(te, [h])
    assert h.response.fsm.state == states.REQUEST_COMPLETED
    pool_clean(te)


# ---------------------------------------------------------------------------
# Session.close and a dead engine
# ---------------------------------------------------------------------------
def test_session_close_cancels_and_refuses(pair):
    vocab = pair[0].vocab_size
    res = []
    for eng in _engines(pair):
        sess = eng.connect(0)
        h = sess.submit_i(np.arange(8) % vocab, max_tokens=32)
        eng.tick()
        sess.close()
        sess.close()                            # idempotent
        for _ in range(50):
            eng.tick()
            if eng.pool.n_seqs() == 0:
                break
        assert eng.pool.free_pages() == eng.pool.n_pages
        h2 = sess.submit_i(np.arange(4) % vocab, max_tokens=4)
        assert h2.done and h2.status.reason == "session closed"
        with eng.connect(0) as sess3:
            h3 = sess3.submit_i(np.arange(8) % vocab, max_tokens=4)
            drive(eng, [h3])
        assert sess3.closed
        res.append((h.req.fsm.state, outcome([h2, h3]), _stats(eng)))
    assert res[0] == res[1]


def test_dead_engine_resolves_handles_and_tick_is_inert(pair):
    """``test_serve_faults.py::test_dead_engine_resolves_handles_fast`` and
    ``test_tick_after_death_is_inert``."""
    vocab = pair[0].vocab_size
    te, _ = _engines(pair)
    sess = te.connect(0)
    h = sess.submit_i(np.arange(8) % vocab, max_tokens=32)
    te.tick()
    te._die("engine loop crashed: test")
    t0 = time.monotonic()
    r = h.wait(timeout_s=30)
    assert time.monotonic() - t0 < 5
    assert isinstance(r, FailedStatus) and not r and "crashed" in r.reason
    t0 = time.monotonic()
    assert not te.get_response(0, timeout_s=30)
    assert time.monotonic() - t0 < 5
    h2 = sess.submit_i(np.arange(4) % vocab, max_tokens=4)
    assert isinstance(h2.wait(timeout_s=5), FailedStatus)
    assert te.pool.n_seqs() == 0
    pool_clean(te)
    assert te.tick() == (0, False) and te.dead.endswith("test")
    fresh, _ = _engines(pair)
    fresh._die("x")
    assert fresh.tick() == (0, False) and fresh.dead == "x"


# ---------------------------------------------------------------------------
# The sweep: the same plans on both engines
# ---------------------------------------------------------------------------
def test_fault_plan_sweep_matches_reference(pair):
    """24 seeded plans over every site the engine probes without a
    snapshot directory: on both engines no tick raises and nothing
    wedges, the terminals are equal, every COMPLETED stream equals the
    run with no fault, and the pool invariants hold after every plan."""
    vocab = pair[0].vocab_size
    prompts = [(np.arange(8) + 3 * i) % vocab for i in range(4)]
    pris, budgets = [2, 0, 1, 0], [12, 4, 6, 4]
    sites = [s for s in faults.SITES
             if not s.startswith(("snapshot", "journal"))]

    def run(eng):
        sessions = [eng.connect(c) for c in range(2)]
        hs = [sessions[i % 2].submit_i(p, max_tokens=budgets[i],
                                       priority=pris[i])
              for i, p in enumerate(prompts)]
        drive(eng, hs)
        return hs

    ov = OverloadPolicy(priorities=True, preemption=True)
    te, th = _both(pair, run, overload=ov, pool_pages=8)
    ref = outcome(th)
    assert all(r[0] == states.REQUEST_COMPLETED for r in ref)
    hit = set()
    tplans = FaultPlan.sweep(24, seed=11, sites=sites)
    jplans = jfaults.FaultPlan.sweep(24, seed=11, sites=sites)
    for tplan, jplan in zip(tplans, jplans):
        rules = [{"site": r.site, "nth": r.nth, "times": r.times}
                 for r in tplan.rules]
        assert rules == [{"site": r.site, "nth": r.nth, "times": r.times}
                         for r in jplan.rules]
        te, th = _both(pair, run, rules, overload=ov, pool_pages=8)
        hit.update(te.faults.fired)
        assert te.dead is None, (tplan, te.dead)
        for got, want in zip(outcome(th), ref):
            if got[0] == states.REQUEST_COMPLETED:
                assert got[1] == want[1], tplan
            else:
                assert got[0] == states.REQUEST_CANCELLED, tplan
        pool_clean(te)
    assert {s.split(".")[0] for s in hit} == {"transport", "pool", "engine"}


def test_fault_plan_sweep_engine_never_wedges(pair):
    """The reference's acceptance sweep on the port's engine: its own
    ``FaultPlan.sweep(50, seed=11)`` over every site (each plan's rules
    equal to ``repro``'s), the priority workload under preemption.  No
    tick raises and nothing wedges, every COMPLETED stream equals the run
    with no fault (itself equal to the reference engine's), every other
    request ends CANCELLED, the pool invariants hold after every plan,
    and every site class but the snapshot and journal ones (armed only
    with a snapshot directory) fires somewhere."""
    vocab = pair[0].vocab_size
    prompts = [(np.arange(8) + 3 * i) % vocab for i in range(4)]
    pris, budgets = [2, 0, 1, 0], [12, 4, 6, 4]
    ov = OverloadPolicy(priorities=True, preemption=True)

    def run(eng):
        sessions = [eng.connect(c) for c in range(2)]
        hs = [sessions[i % 2].submit_i(p, max_tokens=budgets[i],
                                       priority=pris[i])
              for i, p in enumerate(prompts)]
        drive(eng, hs)
        pool_clean(eng)
        return eng, hs

    _, ref_handles = _both(pair, lambda e: run(e)[1], overload=ov,
                           pool_pages=8)
    ref = outcome(ref_handles)
    assert all(r[0] == states.REQUEST_COMPLETED for r in ref)
    tplans = FaultPlan.sweep(50, seed=11)
    jplans = jfaults.FaultPlan.sweep(50, seed=11)
    assert faults.SITES == jfaults.SITES
    hit = set()
    for tplan, jplan in zip(tplans, jplans):
        rules = [(r.site, r.nth, r.times) for r in tplan.rules]
        assert rules == [(r.site, r.nth, r.times) for r in jplan.rules]
        te = ServeEngine(pair[3], pair[4], device="cpu", fault_plan=tplan,
                         overload=ov, **_kw(pool_pages=8, tick_retries=1))
        te, th = run(te)
        hit.update(tplan.fired)
        assert te.dead is None, (tplan, te.dead)
        for got, want in zip(outcome(th), ref):
            if got[0] == states.REQUEST_COMPLETED:
                assert got[1] == want[1], tplan
            else:
                assert got[0] == states.REQUEST_CANCELLED, tplan
        s = te.stats
        terminal = (s["served"] + s["rejected"] + s["cancelled"]
                    + s["shed_requests"] + s["requests_failed"])
        assert terminal >= len(th)
    assert {s.split(".")[0] for s in hit} == \
        {s.split(".")[0] for s in faults.SITES} - {"snapshot", "journal"}
