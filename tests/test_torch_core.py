"""The carried lock-free core, run under both packages: each behaviour
test of ``repro.core`` that the port's copy must keep is parametrised
over ``repro`` and ``repro_torch`` (HostNBB SPSC FIFO and wrap, burst
send/drain, MpscQueue fan-in, the Figure-3/4 FSMs, the RefCountArray
lifecycle, the NBW cell, SimNBB torn states)."""
import importlib
import threading

import pytest

pytest.importorskip("torch")


class _Pkg:
    def __init__(self, root):
        core = f"{root}.core"
        self.nbb = importlib.import_module(f"{core}.nbb")
        self.nbw = importlib.import_module(f"{core}.nbw")
        self.states = importlib.import_module(f"{core}.states")
        self.refcount = importlib.import_module(f"{core}.refcount")
        self.hq = importlib.import_module(f"{core}.host_queue")
        self.transport = importlib.import_module(f"{core}.transport")


@pytest.fixture(params=["repro", "repro_torch"])
def pkg(request):
    return _Pkg(request.param)


def test_hostnbb_fifo_and_full_empty(pkg):
    q = pkg.nbb.HostNBB(8)
    for i in range(8):
        assert q.insert_item(i) == pkg.nbb.OK
    assert q.insert_item(99) == pkg.nbb.BUFFER_FULL
    for i in range(8):
        assert q.read_item() == (pkg.nbb.OK, i)
    assert q.read_item() == (pkg.nbb.BUFFER_EMPTY, None)


def test_hostnbb_wraparound(pkg):
    q = pkg.nbb.HostNBB(3)
    for round_ in range(10):
        for i in range(3):
            assert q.insert_item((round_, i)) == pkg.nbb.OK
        for i in range(3):
            assert q.read_item() == (pkg.nbb.OK, (round_, i))


@pytest.mark.parametrize("capacity", [1, 2, 16])
def test_hostnbb_spsc_threads_in_order(pkg, capacity):
    """The paper's stress test: transaction ids 1..1000 arrive in order."""
    q = pkg.nbb.HostNBB(capacity)
    n, received = 1000, []
    t1 = threading.Thread(target=lambda: [q.put(i) for i in
                                          range(1, n + 1)])
    t2 = threading.Thread(target=lambda: [received.append(q.get())
                                          for _ in range(n)])
    t1.start()
    t2.start()
    t1.join(30)
    t2.join(30)
    assert not t1.is_alive() and not t2.is_alive()
    assert received == list(range(1, n + 1))


def test_burst_fifo_across_wraparound(pkg):
    q = pkg.hq.SpscQueue(8)
    sent, got, i = [], [], 0
    for size in (5, 6, 7, 3, 8, 1, 6, 4):
        vals = list(range(i, i + size))
        assert q.send_burst(vals) == (pkg.nbb.OK, size)
        sent += vals
        i += size
        got += q.drain_burst()
    assert got == sent
    assert q.drain_burst() == [] and len(q) == 0


def test_burst_partial_send_and_drain(pkg):
    q = pkg.hq.SpscQueue(4)
    q.send("x")
    status, n = q.send_burst(list(range(5)))
    assert status == pkg.nbb.BUFFER_FULL and n == 3
    assert q.drain_burst(2) == ["x", 0]
    assert q.try_recv() == (pkg.nbb.OK, 1)
    assert q.drain_burst() == [2]


def test_mpsc_fan_in_keeps_per_producer_fifo(pkg):
    q = pkg.hq.MpscQueue(nproducers=4, capacity_per_producer=16)
    n_each, got = 300, []

    def producer(pid):
        for i in range(n_each):
            q.producer(pid).put((pid, i))

    ts = [threading.Thread(target=producer, args=(p,)) for p in range(4)]
    tc = threading.Thread(target=lambda: [got.append(q.get())
                                          for _ in range(4 * n_each)])
    for t in ts + [tc]:
        t.start()
    for t in ts + [tc]:
        t.join(30)
    assert not any(t.is_alive() for t in ts + [tc])
    for pid in range(4):
        assert [i for (p, i) in got if p == pid] == list(range(n_each))


def test_request_fsm_transitions(pkg):
    st = pkg.states
    c = st.request_cell()
    c.transition(st.REQUEST_FREE, st.REQUEST_VALID)
    c.transition(st.REQUEST_VALID, st.REQUEST_RECEIVED)
    assert c.cas(st.REQUEST_RECEIVED, st.REQUEST_CANCELLED)
    assert not c.cas(st.REQUEST_RECEIVED, st.REQUEST_COMPLETED)
    c.transition(st.REQUEST_CANCELLED, st.REQUEST_FREE)
    with pytest.raises(st.IllegalTransition):
        c.cas(st.REQUEST_FREE, st.REQUEST_COMPLETED)


def test_buffer_fsm_figure4_and_reserved_abort(pkg):
    st = pkg.states
    c = st.buffer_cell()
    for a, b in [(st.BUFFER_FREE, st.BUFFER_RESERVED),
                 (st.BUFFER_RESERVED, st.BUFFER_ALLOCATED),
                 (st.BUFFER_ALLOCATED, st.BUFFER_RECEIVED),
                 (st.BUFFER_RECEIVED, st.BUFFER_FREE),
                 (st.BUFFER_FREE, st.BUFFER_RESERVED),
                 (st.BUFFER_RESERVED, st.BUFFER_FREE)]:
        c.transition(a, b)
    assert c.state == st.BUFFER_FREE


def test_fsm_racing_threads_single_winner(pkg):
    st = pkg.states
    c = st.request_cell()
    for _ in range(30):
        wins = []

        def claimer(tid):
            if c.cas(st.REQUEST_FREE, st.REQUEST_VALID):
                wins.append(tid)

        ts = [threading.Thread(target=claimer, args=(i,)) for i in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(10)
        assert len(wins) == 1
        c.transition(st.REQUEST_VALID, st.REQUEST_COMPLETED)
        c.transition(st.REQUEST_COMPLETED, st.REQUEST_FREE)


def test_journal_compaction_preserves_state(pkg):
    st = pkg.states
    c = st.request_cell()
    for _ in range(100):
        c.transition(st.REQUEST_FREE, st.REQUEST_VALID)
        c.transition(st.REQUEST_VALID, st.REQUEST_COMPLETED)
        c.transition(st.REQUEST_COMPLETED, st.REQUEST_FREE)
    assert c.state == st.REQUEST_FREE


def test_refcount_lifecycle(pkg):
    r = pkg.refcount.RefCountArray(4)
    assert r.try_claim() == 0
    assert r.incref(0) == 2
    assert r.decref(0) == 1
    assert r.shared_count() == 0 and r.count() == 1
    assert r.decref(0) == 0
    assert not r.is_claimed(0)
    with pytest.raises(KeyError):
        r.decref(0)
    assert sorted(r.try_claim() for _ in range(4)) == [0, 1, 2, 3]
    assert r.try_claim() is None
    r.release(2)
    assert r.claim_specific(2) is True and r.claim_specific(2) is False


def test_nbw_freshest_value_wins(pkg):
    w = pkg.nbw.HostNBW(depth=2)
    for v in range(5):
        w.write(v)
    assert w.read() == 4 and w.version == 5


def test_simnbb_never_reads_a_torn_slot(pkg):
    s = pkg.nbb.SimNBB(2)
    assert s.try_begin_insert() == pkg.nbb.OK
    s.write_half(7)
    assert s.try_begin_read() == pkg.nbb.BUFFER_EMPTY_BUT_PRODUCER_INSERTING
    s.write_commit(7)
    assert s.try_begin_read() == pkg.nbb.OK
    assert s.read_commit() == (7, 0)


def test_transport_send_i_handle_completes(pkg):
    q = pkg.hq.SpscQueue(1)
    assert q.send("a") == pkg.nbb.OK
    h = pkg.transport.send_i(q, "b")      # ring full: stays pending
    assert not h.test()
    assert q.try_recv() == (pkg.nbb.OK, "a")
    assert h.test() and h.completed
    assert q.try_recv() == (pkg.nbb.OK, "b")
