"""Port counterpart of ``tests/test_faults.py``: the fault-injection
layer of ``repro_torch`` below the engine (DESIGN.md §13).

  * FaultPlan scheduling — nth/times windows, fnmatch site classes,
    pause() re-entrancy, seeded determinism (the same rules as the
    reference's for the same seed), sweep coverage,
  * FaultyTransport — refusals surface as Table-1 statuses, raise
    actions carry retryable metadata, zero interference when no rule
    matches,
  * the partial-failure property: a producer killed mid-``send_burst``
    span reservation never exposes a torn or reordered span to
    consumers (SPSC, MPSC fan-in, PriorityTransport), deterministic +
    hypothesis-guarded,
  * pool probes (claim/extend/CoW/swap) leave tables/refcounts/free
    count at pre-op values; quarantine pins private pages forever.  The
    port's pools live on the CPU here (``device="cpu"``), and each
    probe's page tables and counts are held to the reference pool's.
"""
import pytest

pytest.importorskip("torch")

try:  # optional dev dependency; property tests skip without it
    from hypothesis import given, settings, strategies as st
except ImportError:
    given = settings = st = None

from repro.core.faults import FaultPlan as RefFaultPlan  # noqa: E402
from repro.core.faults import FaultRule as RefFaultRule  # noqa: E402
from repro.serve.kv_cache import PagedKVPool as RefPagedKVPool  # noqa: E402
from repro_torch.core import faults, nbb  # noqa: E402
from repro_torch.core.faults import (ACT_RAISE, ACT_REFUSE,  # noqa: E402
                                     FaultPlan, FaultRule, InjectedFault,
                                     recover_ring, stall_mid_burst)
from repro_torch.core.host_queue import MpscQueue, SpscQueue  # noqa: E402
from repro_torch.core.transport import (FaultyTransport,  # noqa: E402
                                        PriorityTransport)
from repro_torch.serve.kv_cache import OK as POOL_OK  # noqa: E402
from repro_torch.serve.kv_cache import POOL_FULL  # noqa: E402
from repro_torch.serve.kv_cache import PagedKVPool  # noqa: E402


def _rules(plan):
    return [(r.site, r.nth, r.times, r.action) for r in plan.rules]


# ---------------------------------------------------------------------------
# FaultPlan scheduling
# ---------------------------------------------------------------------------
def test_plan_nth_window():
    plan = FaultPlan([FaultRule("x", nth=2, times=2)])
    assert [plan.fire("x") for _ in range(5)] == \
        [None, ACT_RAISE, ACT_RAISE, None, None]
    assert plan.n_fired == 2 and plan.fired == ["x", "x"]


def test_plan_site_pattern_matches_class():
    plan = FaultPlan([FaultRule("pool.*", nth=1, times=1)])
    assert plan.fire("pool.claim") == ACT_REFUSE    # catalog default
    assert plan.fire("pool.extend") is None         # window consumed
    assert plan.fire("transport.send") is None      # never matched


def test_plan_unmatched_site_never_advances_counter():
    plan = FaultPlan([FaultRule("a", nth=1)])
    for _ in range(10):
        assert plan.fire("b") is None
    assert plan.fire("a") == ACT_RAISE              # still the 1st probe


def test_plan_explicit_action_overrides_default():
    plan = FaultPlan([FaultRule("transport.send", action=ACT_RAISE)])
    assert plan.fire("transport.send") == ACT_RAISE


def test_plan_pause_is_reentrant_and_suppresses_counting():
    plan = FaultPlan([FaultRule("x", nth=1)])
    with plan.pause():
        with plan.pause():
            assert plan.fire("x") is None
        assert plan.fire("x") is None
    # paused probes did not consume the window
    assert plan.fire("x") == ACT_RAISE


def test_plan_random_is_seed_deterministic():
    a = FaultPlan.random(seed=7)
    b = FaultPlan.random(seed=7)
    assert [(r.site, r.nth, r.times) for r in a.rules] == \
        [(r.site, r.nth, r.times) for r in b.rules]
    assert _rules(a) == _rules(RefFaultPlan.random(seed=7))


def test_sweep_covers_every_site_class():
    plans = FaultPlan.sweep(50, seed=3)
    assert [_rules(p) for p in plans] == [
        _rules(p) for p in RefFaultPlan.sweep(50, seed=3)]
    pinned = {p.rules[0].site for p in plans}
    assert pinned == set(faults.SITES)
    for p in plans:
        assert all(r.times >= 1 for r in p.rules)


def test_injected_fault_metadata():
    e = InjectedFault("engine.sync", seq=4, retryable=False)
    assert e.site == "engine.sync" and e.seq == 4 and not e.retryable
    assert "engine.sync" in str(e)


# ---------------------------------------------------------------------------
# FaultyTransport refusals
# ---------------------------------------------------------------------------
def test_faulty_transport_passthrough_when_no_rule_matches():
    ring = SpscQueue(4)
    ft = FaultyTransport(ring, FaultPlan([]))
    assert ft.send(1) == nbb.OK
    status, got = ft.try_recv()
    assert (status, got) == (nbb.OK, 1)
    assert ft.send_burst([2, 3]) == (nbb.OK, 2)
    assert ft.drain_burst() == [2, 3]


def test_faulty_transport_send_refusal_is_table1_full():
    ring = SpscQueue(4)
    ft = FaultyTransport(ring, FaultPlan([FaultRule("transport.send")]))
    assert ft.send(1) == nbb.BUFFER_FULL    # refused, nothing inserted
    assert len(ring) == 0
    assert ft.send(2) == nbb.OK             # window consumed: healthy


def test_faulty_transport_recv_refusal_is_table1_empty():
    ring = SpscQueue(4)
    ring.send(9)
    ft = FaultyTransport(ring, FaultPlan([FaultRule("transport.recv")]))
    assert ft.try_recv() == (nbb.BUFFER_EMPTY, None)
    assert ft.try_recv() == (nbb.OK, 9)     # the item was never lost


def test_faulty_transport_raise_action():
    ft = FaultyTransport(SpscQueue(4), FaultPlan(
        [FaultRule("transport.send", action=ACT_RAISE)]))
    with pytest.raises(InjectedFault) as ei:
        ft.send(1)
    assert ei.value.retryable


# ---------------------------------------------------------------------------
# Torn-span safety: producer dies mid-send_burst (the satellite test)
# ---------------------------------------------------------------------------
def _stalled_ring(prefix, dying, capacity=16):
    """A ring holding ``prefix`` committed, then a producer that dies
    mid-burst of ``dying`` (announced, partially written, uncommitted)."""
    ring = SpscQueue(capacity)
    for v in prefix:
        assert ring.send(v) == nbb.OK
    ft = FaultyTransport(ring, FaultPlan([FaultRule("transport.stall")]))
    with pytest.raises(InjectedFault) as ei:
        ft.send_burst(dying)
    assert not ei.value.retryable           # the producer is DEAD
    return ring


def test_spsc_consumer_never_sees_torn_span():
    ring = _stalled_ring([1, 2], [10, 11, 12])
    # Committed prefix only: the announced span is invisible.
    assert len(ring) == 2
    assert ring.drain_burst() == [1, 2]
    assert ring.drain_burst() == []
    # The scalar read on the boundary reports the Table-1 transient
    # status (producer "inserting"), never a torn value.
    status, got = ring.try_recv()
    assert status == nbb.BUFFER_EMPTY_BUT_PRODUCER_INSERTING and got is None


def test_recover_ring_resumes_service():
    ring = _stalled_ring([1], [10, 11])
    assert recover_ring(ring)               # lease owner declares it dead
    assert not recover_ring(ring)           # idempotent
    assert ring.drain_burst() == [1]
    # A new producer reuses the span cleanly — old junk is overwritten.
    assert ring.send_burst([7, 8]) == (nbb.OK, 2)
    assert ring.drain_burst() == [7, 8]


def test_stall_on_full_ring_leaves_it_untouched():
    ring = SpscQueue(2)
    ring.send(1)
    ring.send(2)
    assert stall_mid_burst(ring, [9]) == 0  # died before announcing
    assert not recover_ring(ring)
    assert ring.drain_burst() == [1, 2]


def test_mpsc_dead_producer_does_not_block_siblings():
    q = MpscQueue(3, capacity_per_producer=8)
    q.producer(0).send_burst([1, 2])
    # producer 1 dies mid-span
    ft = FaultyTransport(q.producer(1), FaultPlan(
        [FaultRule("transport.stall")]))
    with pytest.raises(InjectedFault):
        ft.send_burst([66, 67])
    q.producer(2).send_burst([3])
    got = q.drain_burst()
    assert sorted(got) == [1, 2, 3]         # healthy rings fully served
    recover_ring(q.producer(1))
    assert q.producer(1).send_burst([4]) == (nbb.OK, 1)
    assert q.drain_burst() == [4]


def test_priority_transport_dead_class_does_not_corrupt_order():
    pt = PriorityTransport([SpscQueue(8) for _ in range(3)])
    pt.classes[0].send_burst([100])
    ft = FaultyTransport(pt.classes[1], FaultPlan(
        [FaultRule("transport.stall")]))
    with pytest.raises(InjectedFault):
        ft.send_burst([55, 56])
    pt.classes[2].send_burst([300, 301])
    # Priority-ordered drain skips the uncommitted span entirely.
    assert pt.drain_burst() == [100, 300, 301]
    recover_ring(pt.classes[1])
    pt.classes[1].send_burst([200])
    assert pt.drain_burst() == [200]


if given is not None:
    class TestTornSpanProperties:
        @given(prefix=st.lists(st.integers(0, 999), max_size=6),
               dying=st.lists(st.integers(0, 999), min_size=1, max_size=6),
               after=st.lists(st.integers(0, 999), max_size=6),
               capacity=st.integers(2, 8))
        @settings(max_examples=120, deadline=None)
        def test_consumer_sees_committed_prefix_then_recovery(
                self, prefix, dying, after, capacity):
            """For ANY committed prefix, dying span, and post-recovery
            burst: the consumer observes exactly prefix ++ after (FIFO,
            no torn values, no reordering)."""
            ring = SpscQueue(capacity)
            kept = []
            for v in prefix:
                if ring.send(v) == nbb.OK:
                    kept.append(v)
            ft = FaultyTransport(ring, FaultPlan(
                [FaultRule("transport.stall")]))
            try:
                ft.send_burst(dying)
            except InjectedFault:
                pass
            assert ring.drain_burst() == kept   # committed prefix only
            recover_ring(ring)
            status, n = ring.send_burst(after)
            assert ring.drain_burst() == list(after[:n])


# ---------------------------------------------------------------------------
# Pool probes: crash-consistent refusal + quarantine
# ---------------------------------------------------------------------------
def _pool(n_pages=8, page_size=4):
    return PagedKVPool(n_pages, page_size, n_layers=1, kv_heads=1,
                       head_dim=2, device="cpu")


def _ref_pool(n_pages=8, page_size=4):
    return RefPagedKVPool(n_pages, page_size, n_layers=1, kv_heads=1,
                          head_dim=2)


def _pool_state(pool):
    """What a probe must leave as the reference's pool leaves it: every
    table's pages and tokens, every page's count, the free and
    quarantined pages."""
    return ({s: (list(t.pages), t.n_tokens) for s, t in pool._tables.items()},
            [pool.refcount(p) for p in range(pool.n_pages)],
            pool.free_pages(), sorted(pool.quarantined))


def _on_both(script):
    """Run a pool ``script(pool, FaultPlan, FaultRule)`` on the port's pool
    and on the reference's, each with its own package's plan: the two
    must observe the same -> the port's observations."""
    got = script(_pool(), FaultPlan, FaultRule)
    assert got == script(_ref_pool(), RefFaultPlan, RefFaultRule)
    return got


def test_pool_claim_fault_rolls_back_nothing():
    def script(pool, Plan, Rule):
        pool.faults = Plan([Rule("pool.claim")])
        out = [pool.try_admit(1, 8), pool.n_seqs(), pool.free_pages()]
        out += [pool.try_admit(1, 8), _pool_state(pool)]  # window consumed
        return out

    got = _on_both(script)
    assert got[:4] == [POOL_FULL, 0, 8, POOL_OK]
    assert got[4][2] == 6


def test_pool_extend_fault_leaves_table_at_preop():
    def script(pool, Plan, Rule):
        out = [pool.try_admit(1, 4), _pool_state(pool)]
        pool.faults = Plan([Rule("pool.extend")])
        out += [pool.extend_reservation(1, 16), _pool_state(pool)]
        out += [pool.extend_reservation(1, 16), _pool_state(pool)]
        return out

    got = _on_both(script)
    assert got[0] == POOL_OK and got[2] == POOL_FULL and got[4] == POOL_OK
    assert got[3] == got[1]                 # table, counts at pre-op
    assert got[3][2] == 7 and got[5][2] == 4


def test_pool_extend_fault_silent_when_no_growth_needed():
    """The probe only fires when pages would actually be claimed — a
    same-size extend (a retried tick's idempotent re-reservation) does
    not consume the fault window."""
    def script(pool, Plan, Rule):
        out = [pool.try_admit(1, 8)]
        pool.faults = Plan([Rule("pool.extend")])
        out += [pool.extend_reservation(1, 8), pool.faults.n_fired]
        return out + [_pool_state(pool)]

    got = _on_both(script)
    assert got[:3] == [POOL_OK, POOL_OK, 0]     # no new pages, no fire


def test_pool_swap_out_fault_raises_premutation():
    pool = _pool()
    assert pool.try_admit(1, 8) == POOL_OK
    pool.note_tokens(1, 8)
    pages_before = list(pool.table(1).pages)
    pool.faults = FaultPlan([FaultRule("pool.swap_out")])
    with pytest.raises(InjectedFault) as ei:
        pool.swap_out_preempt(1, 8)
    assert ei.value.retryable
    assert pool.table(1).pages == pages_before  # nothing moved
    assert pool.swap_out_bytes == 0
    before = _pool_state(pool)
    img = pool.swap_out_preempt(1, 8)           # healthy after window
    assert pool.swap_in_preempt(1, img) == POOL_OK

    ref = _ref_pool()
    ref.try_admit(1, 8)
    ref.note_tokens(1, 8)
    ref.faults = RefFaultPlan([RefFaultRule("pool.swap_out")])
    with pytest.raises(Exception, match="pool.swap_out"):
        ref.swap_out_preempt(1, 8)
    assert before == _pool_state(ref)
    ref.swap_in_preempt(1, ref.swap_out_preempt(1, 8))
    assert _pool_state(pool) == _pool_state(ref)
    assert (pool.swap_out_bytes, pool.swap_in_bytes) == (
        ref.swap_out_bytes, ref.swap_in_bytes)


def test_pool_quarantine_pins_private_pages_forever():
    def script(pool, Plan, Rule):
        out = [pool.try_admit(1, 8)]                # 2 private pages
        out += [pool.quarantine_range(1, 0, 8)]
        out += [pool.quarantine_range(1, 0, 8)]     # idempotent
        pool.free(1)
        out += [pool.n_seqs(), pool.used_pages(), _pool_state(pool)]
        out += [pool.try_admit(2, 24), _pool_state(pool)]
        return out

    admit, got, again, n_seqs, used, after_free, admit2, final = \
        _on_both(script)
    assert admit == POOL_OK and len(got) == 2 and again == []
    # The owner's free dropped its ref, but the quarantine pin holds:
    # the pages stay accounted used and can never be claimed again.
    assert n_seqs == 0 and used == 2 and after_free[3] == sorted(got)
    assert all(after_free[1][p] == 1 for p in got)
    # Six pages remain claimable; the quarantined two are never handed out.
    assert admit2 == POOL_OK
    assert set(final[0][2][0]).isdisjoint(got)


def test_pool_quarantine_skips_shared_pages():
    def script(pool, Plan, Rule):
        out = [pool.try_admit(1, 8)]
        pool.adopt_shared(2, list(pool.table(1).pages), 8)  # second holder
        out += [pool.quarantine_range(1, 0, 8), pool.stats()["quarantined"]]
        return out + [_pool_state(pool)]

    got = _on_both(script)
    assert got[:3] == [POOL_OK, [], 0]
