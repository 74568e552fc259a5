"""The port's overload control against the JAX package's: the
multi-class weighted-fair intake (``PriorityIntake``), the pool's
page-swap preemption round trip, and the ``slot_paged`` engine under an
``OverloadPolicy`` — preemption, resume, SLO shedding and aging give the
same streams, the same Figure-4 states and the same counters as
``repro`` on the same seeded weights, at the SMOKE size in float32.
Also: a parked sequence's tombstoned row never reaches a dispatched
block table, and ``_block_table`` refuses one that would; and the
reference's randomized preempt/resume storm on both pools."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

try:  # optional dev dependency (requirements-dev.txt)
    from hypothesis import given, settings, strategies as st
except ImportError:
    st = None

from _torch_parity import (drive, outcome, pool_clean, share_jit,  # noqa: E402
                           smoke_pair)
from repro.core import nbb as jnbb  # noqa: E402
from repro.serve import overload as jov  # noqa: E402
from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.core import nbb, states  # noqa: E402
from repro_torch.core.host_queue import MpscQueue  # noqa: E402
from repro_torch.serve import overload as tov  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.kv_cache import OK, POOL_FULL, PagedKVPool  # noqa: E402

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


COUNTERS = ("preemptions", "resumes", "shed_requests", "swap_out_bytes",
            "swap_in_bytes", "host_syncs", "decode_steps", "prefill_chunks",
            "served", "cancelled", "rejected")


# ---------------------------------------------------------------------------
# PriorityIntake: the same drain order as the reference's
# ---------------------------------------------------------------------------
def _intake_order(mod, n_clients, policy_kw, feed, pops, cost=None):
    """Feed (client, class, item) into ``mod.PriorityIntake``, pop
    ``pops`` times (charging ``cost(item)`` per pop when given); return
    the (status, item, promoted) sequence."""
    q = mod.PriorityIntake(n_clients, mod.OverloadPolicy(**policy_kw), 16)
    for c, pri, item in feed:
        assert q.producer(c, pri).insert_item(item) == 0
    out = []
    for _ in range(pops):
        status, item, promoted = q.pop()
        out.append((status, item, promoted))
        if cost is not None and item is not None:
            q.charge(item[0], cost(item))
    return out, q.vtimes()


INTAKE_CASES = {
    "strict": (1, {"wfq": False},
               [(0, 2, (0, "l1")), (0, 1, (0, "n1")), (0, 0, (0, "h1")),
                (0, 0, (0, "h2"))], 5, None),
    "aging": (1, {"wfq": False, "aging_limit": 2},
              [(0, 2, (0, "low"))] + [(0, 0, (0, f"h{i}"))
                                      for i in range(6)], 8, None),
    "wfq": (2, {}, [(0, 1, (0, i)) for i in range(6)]
            + [(1, 1, (1, i)) for i in range(2)], 8, lambda it: 10.0),
    "weights": (2, {"weights": (3.0, 1.0)},
                [(c, 1, (c, i)) for i in range(6) for c in (0, 1)], 10,
                lambda it: 12.0),
    "one_class": (3, {"priorities": False},
                  [(0, 0, (0, "x")), (1, 2, (1, "y")), (2, 1, (2, "z"))],
                  4, None),
    "mixed": (3, {"aging_limit": 3, "weights": (1.0, 2.0, 0.5)},
              [(c, (c + i) % 3, (c, i)) for i in range(5) for c in range(3)],
              16, lambda it: 4.0 + it[1]),
}


def _clients(order, n):
    """The clients of the first ``n`` pops' items."""
    return [item[0] for _, item, _ in order[:n]]


# The reference's own assertions on each case's drain order.
INTAKE_CHECKS = {
    "strict": lambda o: (
        [item[1] for _, item, _ in o[:4]] == ["h1", "h2", "n1", "l1"]
        and o[4] == (nbb.BUFFER_EMPTY, None, False)),
    "aging": lambda o: (
        all(status == nbb.OK for status, _, _ in o[:7])
        and [(item[1], p) for _, item, p in o[:3]]
        == [("h0", False), ("h1", False), ("low", True)]
        and [item[1] for _, item, _ in o[3:7]] == ["h2", "h3", "h4", "h5"]),
    "wfq": lambda o: (_clients(o, 4).count(1) == 2
                      and _clients(o, 8).count(0) == 6),
    "weights": lambda o: _clients(o, 8).count(0) >= 5,
    "one_class": lambda o: (
        {o[0][1][1], o[1][1][1]} == {"x", "y"}
        and tov.PriorityIntake(3, tov.OverloadPolicy(priorities=False),
                               8).n_classes == 1),
}


@pytest.mark.parametrize("case", sorted(INTAKE_CASES))
def test_priority_intake_order_matches_reference(case):
    """The drain order of each case equals the reference's, and meets the
    reference's own assertions: ``test_serve_overload.py::
    test_intake_strict_priority_order`` (strict),
    ``test_intake_aging_promotes_starved_class`` (aging),
    ``test_intake_wfq_interleaves_flooding_client`` (wfq),
    ``test_intake_wfq_weights_bias_service`` (weights) and
    ``test_intake_priorities_off_single_class`` (one_class)."""
    n, kw, feed, pops, cost = INTAKE_CASES[case]
    got = _intake_order(tov, n, kw, feed, pops, cost)
    want = _intake_order(jov, n, kw, feed, pops, cost)
    assert got == want
    assert nbb.BUFFER_EMPTY == jnbb.BUFFER_EMPTY
    if case in INTAKE_CHECKS:
        assert INTAKE_CHECKS[case](got[0]), got[0]


def test_policy_validation_and_shed_status():
    """``test_serve_overload.py::test_policy_validation`` and
    ``test_shed_status_is_falsy``."""
    for kw in ({"n_classes": 0}, {"aging_limit": 0}):
        with pytest.raises(ValueError):
            tov.OverloadPolicy(**kw)
        with pytest.raises(ValueError):
            jov.OverloadPolicy(**kw)
    s = tov.ShedStatus(waited_s=1.5, slo_s=1.0, priority=tov.PRIORITY_LOW)
    assert not s and isinstance(s, tov.ShedStatus) and s.priority == 2
    assert (tov.PRIORITY_HIGH, tov.PRIORITY_NORMAL, tov.PRIORITY_LOW) == \
        (jov.PRIORITY_HIGH, jov.PRIORITY_NORMAL, jov.PRIORITY_LOW)


# ---------------------------------------------------------------------------
# The pool's preemption round trip
# ---------------------------------------------------------------------------
def _pool(n_pages, ps=4, L=2, hkv=2, hd=4, dtype=torch.float32):
    return PagedKVPool(n_pages, ps, L, hkv, hd, dtype=dtype, device="cpu")


def _stamp(pool, pages, base):
    """Write identifiable values into whole pages; returns (k, v)."""
    idx = torch.tensor(pages)
    shape = (len(pages),) + tuple(pool.k.shape[1:])
    kv = base + torch.arange(int(np.prod(shape)),
                             dtype=torch.float32).reshape(shape)
    pool.k[idx] = kv.to(pool.k.dtype)
    pool.v[idx] = (kv + 0.5).to(pool.v.dtype)
    return pool.k[idx].clone(), pool.v[idx].clone()


def test_pool_preempt_roundtrip_byte_identical():
    pool = _pool(8)
    sink_k = pool.store_k[8].clone()
    assert pool.try_admit(1, 10) == OK          # 3 pages
    want_k, want_v = _stamp(pool, pool.table(1).pages, 100.0)
    img = pool.swap_out_preempt(1, 10)
    assert img.rows == [0, 1, 2] and not img.dead_rows
    assert not img.shared_rows
    assert pool.table(1).pages == [-1, -1, -1]
    assert pool.free_pages() == 8
    assert pool.swap_out_bytes == 3 * pool.page_nbytes == img.nbytes
    assert pool.try_admit(2, 16) == OK          # dirty the freed pages
    _stamp(pool, pool.table(2).pages, 900.0)
    pool.free(2)
    assert pool.swap_in_preempt(1, img) == OK
    pages = pool.table(1).pages
    assert all(p >= 0 for p in pages)
    assert torch.equal(pool.k[torch.tensor(pages)], want_k)
    assert torch.equal(pool.v[torch.tensor(pages)], want_v)
    assert pool.swap_in_bytes == 3 * pool.page_nbytes
    assert pool.kv_copy_bytes == pool.swap_in_bytes + pool.swap_out_bytes
    assert torch.equal(pool.store_k[8], sink_k)  # the sink never moved
    pool.free(1)
    assert pool.free_pages() == 8
    pool.reset_traffic()
    assert pool.kv_copy_bytes == pool.swap_in_bytes == 0
    assert pool.swap_out_bytes == pool.stats()["kv_resident_bytes_peak"] == 0


def test_pool_preempt_releases_reserved_ahead_without_copy():
    """``test_serve_overload.py::test_pool_preempt_skips_reserved_ahead_pages``."""
    pool = _pool(8, L=1, hkv=1, hd=2)
    assert pool.try_admit(1, 20) == OK          # 5 pages reserved
    img = pool.swap_out_preempt(1, 6)           # only 2 pages live
    assert img.rows == [0, 1] and img.dead_rows == [2, 3, 4]
    assert pool.swap_out_bytes == 2 * pool.page_nbytes
    assert pool.free_pages() == 8
    assert pool.swap_in_preempt(1, img) == OK
    assert all(p >= 0 for p in pool.table(1).pages)
    pool.free(1)
    assert pool.free_pages() == 8


def test_pool_preempt_never_moves_shared_pages():
    pool = _pool(8)
    assert pool.try_admit(1, 12) == OK
    t = pool.table(1)
    shared = t.pages[0]
    pool.incref_pages([shared])                 # the cache's residency ref
    want = pool.k[shared].clone()
    img = pool.swap_out_preempt(1, 12)
    assert img.shared_rows == [0] and img.rows == [1, 2]
    assert t.pages[0] == shared and pool.refcount(shared) == 2
    assert pool.swap_out_bytes == 2 * pool.page_nbytes
    assert pool.swap_in_preempt(1, img) == OK
    assert t.pages[0] == shared and torch.equal(pool.k[shared], want)
    assert pool.cow_copy_bytes == 0
    pool.free(1)
    assert pool.refcount(shared) == 1
    pool.decref_pages([shared])
    assert pool.free_pages() == 8


def test_pool_swap_in_pool_full_leaves_image_intact():
    pool = _pool(4, L=1, hkv=1, hd=2)
    assert pool.try_admit(1, 8) == OK
    want, _ = _stamp(pool, pool.table(1).pages, 7.0)
    img = pool.swap_out_preempt(1, 8)
    assert pool.try_admit(2, 16) == OK          # hog the whole pool
    assert pool.swap_in_preempt(1, img) == POOL_FULL
    assert pool.table(1).pages == [-1, -1]      # untouched, retryable
    pool.free(2)
    assert pool.swap_in_preempt(1, img) == OK
    assert torch.equal(pool.k[torch.tensor(pool.table(1).pages)], want)
    pool.free(1)
    assert pool.free_pages() == 4


def test_pool_free_while_parked():
    pool = _pool(4, L=1, hkv=1, hd=2, dtype=torch.bfloat16)
    assert pool.try_admit(1, 8) == OK
    img = pool.swap_out_preempt(1, 8)
    assert img.k.dtype == np.int16              # bf16 travels as its bits
    pool.free(1)
    assert pool.free_pages() == 4 and pool.n_seqs() == 0


def _storm(ops):
    """Run an admit (0) / preempt oldest live (1) / resume oldest parked
    (2) / free newest (3) sequence on both pools: the same statuses,
    images (rows, dead rows, shared rows), page numbers and counters;
    every resumed page and every survivor reads back its bytes; freeing
    everything leaks nothing, and the copy ledger is swap traffic."""
    import jax.numpy as jnp
    from repro.serve.kv_cache import PagedKVPool as JaxPool
    tp = _pool(12, ps=2, L=1, hkv=1, hd=2)
    jp = JaxPool(12, 2, 1, 1, 2, dtype=jnp.float32)
    nxt, live, parked, want = 0, {}, {}, {}
    for op in ops:
        if op == 0:
            n_tok = 3 + (nxt % 3)
            st_ = tp.try_admit(nxt, n_tok)
            assert st_ == jp.try_admit(nxt, n_tok)
            if st_ == OK:
                want[nxt], _ = _stamp(tp, tp.table(nxt).pages, 100.0 * nxt)
                live[nxt] = n_tok
                nxt += 1
        elif op == 1 and live:
            sid = min(live)
            n = live.pop(sid)
            ti, ji = tp.swap_out_preempt(sid, n), jp.swap_out_preempt(sid, n)
            assert (ti.rows, ti.dead_rows, ti.shared_rows) == \
                (ji.rows, ji.dead_rows, ji.shared_rows)
            parked[sid] = (ti, ji)
        elif op == 2 and parked:
            sid = min(parked)
            ti, ji = parked[sid]
            st_ = tp.swap_in_preempt(sid, ti)
            assert st_ == jp.swap_in_preempt(sid, ji)
            if st_ == OK:
                parked.pop(sid)
                live[sid] = len(ti.rows) * tp.page_size
                pages = tp.table(sid).pages
                assert torch.equal(tp.k[torch.tensor(pages)], want[sid])
        elif op == 3 and (live or parked):
            sid = max(list(live) + list(parked))
            live.pop(sid, None)
            parked.pop(sid, None)
            tp.free(sid)
            jp.free(sid)
        assert {s: tp.table(s).pages for s in live} == \
            {s: jp.table(s).pages for s in live}
    for key in ("kv_copy_bytes", "swap_in_bytes", "swap_out_bytes", "used",
                "free"):
        assert tp.stats()[key] == jp.stats()[key], key
    for sid in live:                            # survivors unscathed
        assert torch.equal(tp.k[torch.tensor(tp.table(sid).pages)],
                           want[sid])
    for sid in list(live) + list(parked):
        tp.free(sid)
        jp.free(sid)
    assert tp.free_pages() == jp.free_pages() == tp.n_pages
    assert tp.kv_copy_bytes == tp.swap_in_bytes + tp.swap_out_bytes


def test_pool_preempt_storm_matches_reference_accounting():
    """A fixed admit/preempt/resume/free interleaving on both pools."""
    _storm([0, 0, 1, 0, 2, 3, 0, 1, 1, 2, 0, 2, 3, 1, 2, 0, 3, 2, 1, 2])


if st is not None:
    @settings(deadline=None, max_examples=20)
    @given(st.lists(st.integers(0, 3), min_size=1, max_size=32))
    def test_pool_preempt_resume_storm(ops):
        """The reference's property: randomized admit/preempt/resume/free
        interleavings on both pools."""
        _storm(ops)
else:                                               # pragma: no cover
    def test_pool_preempt_resume_storm():
        pytest.skip("hypothesis not installed")


# ---------------------------------------------------------------------------
# The engine under an OverloadPolicy, against the reference
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def pair():
    jcfg, jm, jp, tm, tp = smoke_pair(scale=3.0)
    donor = JaxEngine(jm, jp, **_kw(1, 24))
    return jcfg, jm, jp, tm, tp, donor


def _kw(max_batch, pool_pages, **extra):
    return dict(max_batch=max_batch, max_len=64, n_clients=2,
                pool_pages=pool_pages, page_size=8, scheduler="slot_paged",
                k_max=4, chunk_tokens=16, **extra)


def _engines(pair, max_batch=1, pool_pages=24, **extra):
    jcfg, jm, jp, tm, tp, donor = pair
    je = JaxEngine(jm, jp, **_kw(max_batch, pool_pages, **_jax(extra)))
    share_jit(je, donor)
    te = ServeEngine(tm, tp, device="cpu",
                     **_kw(max_batch, pool_pages, **extra))
    return je, te


def _jax(extra):
    """The same knobs for the reference: its own OverloadPolicy class."""
    out = dict(extra)
    if out.get("overload") is not None:
        import dataclasses
        out["overload"] = jov.OverloadPolicy(
            **dataclasses.asdict(out["overload"]))
    return out


def _counters(eng):
    return {k: eng.stats[k] for k in COUNTERS}


def _preempt_scenario(eng, vocab, cancel_parked=False):
    """Low-priority request mid-decode, then a high-priority arrival
    that needs its slot.  Returns (low handle, high handle, parked
    states seen while parked)."""
    hl = eng.connect(0).submit_i(np.arange(8) % vocab, max_tokens=16,
                                 priority=2)
    for _ in range(3):
        eng.tick()
    hh = eng.connect(1).submit_i((np.arange(6) + 3) % vocab, max_tokens=8,
                                 priority=0)
    eng.tick()                          # the sweep preempts and binds high
    seen = [(p.fsm.state, p.req.req_id, p.generated) for p in eng._parked]
    assert len(eng._parked) == 1
    parked = eng._parked[0]
    assert parked.fsm.state == states.BUFFER_PREEMPTED
    assert parked.req is hl.req and parked.generated > 0
    slot = eng.slots[0]                 # the vacated slot binds high
    assert slot.request is not None and slot.request.eff_priority == 0
    assert all(p == -1 or eng.pool.refcount(p) >= 1
               for p in eng.pool.table(parked.req.req_id).pages)
    if cancel_parked:
        assert hl.cancel()
    drive(eng, [hl, hh])
    assert not eng._parked
    return hl, hh, seen


def test_preempt_resume_matches_reference(pair):
    """The tentpole end to end: a high-priority arrival preempts the
    decoding low-priority sequence (its private pages swap host-side),
    runs to completion, and the victim resumes — streams, Figure-4
    states while parked and every counter equal the reference's, and
    both streams equal the unpreempted runs.  Holds
    ``test_serve_overload.py::test_engine_preempt_resume_byte_identical``
    and ``test_engine_preempted_slot_fsm_states`` (the parked cell
    PREEMPTED, the vacated slot bound to the preemptor)."""
    vocab = pair[0].vocab_size
    je, te = _engines(pair, overload=tov.OverloadPolicy())
    jl, jh, jseen = _preempt_scenario(je, vocab)
    tl, th, tseen = _preempt_scenario(te, vocab)
    assert outcome([tl, th]) == outcome([jl, jh])
    assert [o[0] for o in outcome([tl, th])] == [states.REQUEST_COMPLETED] * 2
    assert tseen == jseen
    assert tseen and tseen[0][0] == states.BUFFER_PREEMPTED
    assert _counters(te) == _counters(je)
    assert te.stats["preemptions"] >= 1 and te.stats["resumes"] >= 1
    pool = te.pool
    assert pool.swap_out_bytes > 0
    assert pool.swap_out_bytes % pool.page_nbytes == 0
    assert pool.kv_copy_bytes == (pool.cow_copy_bytes + pool.swap_in_bytes
                                  + pool.swap_out_bytes)
    assert te.stats["swap_in_bytes"] == pool.swap_in_bytes
    assert set(te.class_ttft()) == set(je.class_ttft()) == {0, 2}
    pool_clean(te)
    # Alone, with no policy: the same streams as the preempted run.
    alone = []
    for c, prompt, n in ((0, np.arange(8) % vocab, 16),
                         (1, (np.arange(6) + 3) % vocab, 8)):
        _, e = _engines(pair)
        h = e.connect(c).submit_i(prompt, max_tokens=n)
        drive(e, [h])
        alone.append(list(map(int, h.response.tokens_out)))
    assert [o[1] for o in outcome([tl, th])] == alone
    assert len(set(alone[0])) > 1       # the streams carry information


def test_parked_row_never_reaches_a_dispatch(pair):
    """Every block table the preemption run dispatches holds no negative
    page, no parked sequence is bound to a slot while it is parked, and
    the resumed row holds only fresh, non-negative pages."""
    vocab = pair[0].vocab_size
    _, te = _engines(pair, overload=tov.OverloadPolicy())
    seen_tables, parked_during = [], []
    orig = te._block_table

    def recording():
        bt = orig()
        seen_tables.append(bt.copy())
        bound = {s.request.req_id for s in te.slots if s.request is not None}
        parked_during.append(bound & {p.req.req_id for p in te._parked})
        return bt
    te._block_table = recording
    hl = te.connect(0).submit_i(np.arange(8) % vocab, max_tokens=16,
                                priority=2)
    for _ in range(3):
        te.tick()
    before = list(te.pool.table(hl.req_id).pages)
    te.connect(1).submit_i((np.arange(6) + 3) % vocab, max_tokens=8,
                           priority=0)
    te.tick()
    assert te.pool.table(hl.req_id).pages[:2] == [-1, -1]
    resumed = []
    resume = te._resume_parked

    def recording_resume(slot, parked):
        ok = resume(slot, parked)
        if ok:
            resumed.append(list(te.pool.table(parked.req.req_id).pages))
        return ok
    te._resume_parked = recording_resume
    drive(te, [hl])
    assert te.stats["preemptions"] == 1 and te.stats["resumes"] == 1
    assert all((bt >= 0).all() for bt in seen_tables)
    assert not any(parked_during)
    assert len(resumed) == 1 and all(p >= 0 for p in resumed[0])
    assert len(resumed[0]) == len(before)


def test_block_table_refuses_a_negative_page(pair):
    vocab = pair[0].vocab_size
    _, te = _engines(pair)
    h = te.connect(0).submit_i(np.arange(8) % vocab, max_tokens=16)
    te.tick()
    te.pool.table(h.req_id).pages[0] = -1
    with pytest.raises(RuntimeError, match="negative page"):
        te._block_table()


def test_preempted_fsm_states_and_cancel_while_parked(pair):
    """``test_serve_overload.py::test_engine_cancel_while_parked``."""
    vocab = pair[0].vocab_size
    je, te = _engines(pair, overload=tov.OverloadPolicy())
    jres = _preempt_scenario(je, vocab, cancel_parked=True)
    tres = _preempt_scenario(te, vocab, cancel_parked=True)
    assert outcome(tres[:2]) == outcome(jres[:2])
    assert tres[0].response.fsm.state == states.REQUEST_CANCELLED
    assert len(tres[0].response.tokens_out) > 0     # partial output
    assert _counters(te) == _counters(je)
    assert not te._parked
    assert te.pool.free_pages() == te.pool.n_pages


def test_slo_shed_matches_reference(pair):
    """``test_serve_overload.py::test_engine_slo_shed``.  An SLO of 1 ns
    always sheds, 300 s never: the verdicts cannot depend on the host's
    speed."""
    vocab = pair[0].vocab_size
    res = []
    for eng, mod in zip(_engines(pair, overload=tov.OverloadPolicy(
            preemption=False, slo_s=1e-9)), (jov, tov)):
        sess = eng.connect(0)
        hs = [sess.submit_i(np.arange(4) % vocab, max_tokens=4),
              sess.submit_i(np.arange(4) % vocab, max_tokens=4, slo_s=300.0)]
        drive(eng, hs)
        assert isinstance(hs[0].status, mod.ShedStatus) and not hs[0].status
        assert hs[0].status.slo_s == 1e-9 and hs[1].status is None
        assert hs[0].response.fsm.state == states.REQUEST_CANCELLED
        assert len(hs[0].response.tokens_out) == 0
        assert hs[1].response.fsm.state == states.REQUEST_COMPLETED
        res.append((outcome(hs), _counters(eng)))
    assert res[0] == res[1]
    assert res[1][1]["shed_requests"] == 1


def test_no_starvation_under_high_flood_matches_reference(pair):
    """``test_serve_overload.py::test_engine_no_starvation_under_high_flood``."""
    vocab = pair[0].vocab_size
    res = []
    for eng in _engines(pair, max_batch=2, pool_pages=32,
                        overload=tov.OverloadPolicy(aging_limit=2)):
        s0, s1 = eng.connect(0), eng.connect(1)
        highs = [s0.submit_i((np.arange(4) + i) % vocab, max_tokens=2,
                             priority=0) for i in range(10)]
        low = s1.submit_i(np.arange(4) % vocab, max_tokens=2, priority=2)
        drive(eng, highs + [low])
        assert all(h.response.fsm.state == states.REQUEST_COMPLETED
                   for h in highs + [low])
        order = sorted(range(11), key=lambda i: (highs + [low])[i]
                       .response.done_t)
        assert order.index(10) < 10     # low finished before the tail
        res.append((outcome(highs + [low]), _counters(eng)))
    assert res[0] == res[1]


def test_overload_off_is_unchanged(pair):
    """``test_serve_overload.py::test_engine_overload_off_is_unchanged``:
    overload=None keeps the flat FIFO intake, the priority argument is
    carried but ignored, and no SLO sheds."""
    vocab = pair[0].vocab_size
    je, te = _engines(pair)
    res = []
    for eng in (je, te):
        h = eng.connect(0).submit_i(np.arange(4) % vocab, max_tokens=3,
                                    priority=0, slo_s=1e-9)
        drive(eng, [h])
        res.append((outcome([h]), _counters(eng)))
    assert res[0] == res[1]
    assert res[1][0][0][0] == states.REQUEST_COMPLETED
    assert isinstance(te.intake, MpscQueue)
    assert te.stats["preemptions"] == te.stats["shed_requests"] == 0


def test_preemption_refused_outside_slot_paged(pair):
    """``test_serve_overload.py::test_preemption_requires_paged_scheduler``."""
    _, jm, jp, tm, tp, _ = pair
    with pytest.raises(ValueError, match="slot_paged"):
        JaxEngine(jm, jp, scheduler="slot_chunked",
                  overload=jov.OverloadPolicy())
    with pytest.raises(ValueError, match="slot_paged"):
        ServeEngine(tm, tp, scheduler="slot_chunked", device="cpu",
                    overload=tov.OverloadPolicy())
    eng = ServeEngine(tm, tp, scheduler="slot_fused", device="cpu",
                      overload=tov.OverloadPolicy(preemption=False))
    assert eng._ov is not None
