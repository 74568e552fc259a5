"""Port counterpart of ``tests/test_transport.py``: the unified
Transport protocol of ``repro_torch``: fairness, STATE semantics,
backoff, codecs.

  * MpscQueue round-robin fairness — a producer that keeps its ring full
    cannot starve the others,
  * the STATE channel recv path (collision -> retry -> freshest value)
    exercised through the shared Transport protocol,
  * the Table-1 Backoff discipline (spin on transient, yield/sleep on
    stable) and the generic drain/blocking helpers,
  * packet-mode burst operations (send_burst/drain_burst): FIFO across
    wrap-around, partial drain, full-ring refusal, and SPSC
    producer/consumer races (hypothesis-guarded).

``TestBurstOps.test_fifo_across_wraparound`` is held on both packages
by ``tests/test_torch_core.py::test_burst_fifo_across_wraparound`` and
not copied here.  Threaded races run on the port alone.  The scripted
sequences whose result is an order (the round-robin rotation, the MPSC
burst drain, the MESSAGE priority classes) also run on the reference's classes, and
the two orders must be equal.
"""
import importlib
import threading
from types import SimpleNamespace

import pytest

pytest.importorskip("torch")

try:  # optional dev dependency; property tests skip without it
    from hypothesis import given, settings, strategies as st
except ImportError:
    given = settings = st = None

from repro_torch.core import nbb, nbw, states, transport  # noqa: E402
from repro_torch.core.channels import (Channel, ChannelType,  # noqa: E402
                                       Domain)
from repro_torch.core.host_queue import (LockedQueue, MpscQueue,  # noqa: E402
                                         SpscQueue)
from repro_torch.core.transport import (Backoff, CodecTransport,  # noqa: E402
                                        OpHandle, StateTransport,
                                        Transport, drain, recv_blocking,
                                        recv_i, send_blocking, send_i)


def _pkg(root):
    core = f"{root}.core"
    hq = importlib.import_module(f"{core}.host_queue")
    ch = importlib.import_module(f"{core}.channels")
    return SimpleNamespace(SpscQueue=hq.SpscQueue, MpscQueue=hq.MpscQueue,
                           LockedQueue=hq.LockedQueue, Domain=ch.Domain,
                           ChannelType=ch.ChannelType)


PORT, REF = _pkg("repro_torch"), _pkg("repro")


def _as_in_reference(script):
    """``script(pkg)`` on the port and on the reference -> the port's
    result, after checking the two are equal."""
    got = script(PORT)
    assert got == script(REF)
    return got


# ---------------------------------------------------------------------------
# Protocol conformance: every queue family is a Transport.
# ---------------------------------------------------------------------------
def test_structural_conformance():
    dom = Domain()
    state_ch = dom.connect(ChannelType.STATE, dom.create_endpoint(0, 1),
                           dom.create_endpoint(1, 1))
    scalar_ch = dom.connect(ChannelType.SCALAR, dom.create_endpoint(0, 2),
                            dom.create_endpoint(1, 2))
    for t in (SpscQueue(4), LockedQueue(4),
              StateTransport(nbw.HostNBW()), state_ch.transport,
              scalar_ch.transport):
        assert isinstance(t, Transport), type(t)
    # MpscQueue is receive-side only: producers go through their private
    # SPSC rings (each a full Transport) to keep the single-writer
    # invariant; the consumer surface is try_recv/drain.
    mpsc = MpscQueue(2)
    assert isinstance(mpsc.producer(0), Transport)
    assert callable(mpsc.try_recv) and callable(mpsc.drain)
    assert not hasattr(mpsc, "send")


def test_channel_has_no_ctype_dispatch_in_hot_path():
    """send/recv are pure delegation: the same code object regardless of
    channel type (dispatch happens once, at connect)."""
    import inspect
    src = inspect.getsource(Channel.send) + inspect.getsource(Channel.recv)
    assert "ctype" not in src and "isinstance" not in src


def test_spsc_drain():
    q = SpscQueue(8)
    for i in range(5):
        assert q.send(i) == nbb.OK
    assert q.drain() == [0, 1, 2, 3, 4]
    assert q.drain() == []
    q.send(9)
    assert q.drain(max_items=0) == []
    assert q.drain() == [9]


# ---------------------------------------------------------------------------
# MpscQueue round-robin fairness: no producer starvation.
# ---------------------------------------------------------------------------
class TestMpscFairness:
    def test_full_ring_cannot_starve_others(self):
        """Producer 0 keeps its ring full; producers 1..3 must still get
        their items through within bounded delay (round-robin drain)."""
        n = 4
        q = MpscQueue(n, capacity_per_producer=4)
        # Ring 0 stays saturated throughout.
        for _ in range(4):
            assert q.producer(0).send(("hog", 0)) == nbb.OK
        for pid in range(1, n):
            assert q.producer(pid).send(("meek", pid)) == nbb.OK

        got = []
        for _ in range(n):
            status, item = q.try_recv()
            assert status == nbb.OK
            got.append(item)
            # The hog instantly refills any slot it gave up.
            while q.producer(0).send(("hog", 0)) == nbb.OK:
                pass
        # Within n consecutive reads every producer was served once:
        # round-robin never returns to ring 0 before visiting 1..3.
        producers_seen = {pid for (_, pid) in got}
        assert producers_seen == set(range(n)), got

    def test_round_robin_cursor_rotates(self):
        def script(m):
            q = m.MpscQueue(3, capacity_per_producer=8)
            for pid in range(3):
                for i in range(3):
                    q.producer(pid).send((pid, i))
            return [q.try_recv()[1][0] for _ in range(9)]

        order = _as_in_reference(script)
        # Perfect rotation when all rings are non-empty.
        assert order == [0, 1, 2] * 3, order

    def test_threaded_hog_vs_meek_producer(self):
        """A flat-out producer and a trickle producer: the trickle's items
        all arrive (exactly once, in order) despite the hog's pressure."""
        q = MpscQueue(2, capacity_per_producer=8)
        stop = threading.Event()
        n_meek = 200

        def hog():
            i = 0
            while not stop.is_set():
                q.producer(0).send(("hog", i))
                i += 1

        def meek():
            for i in range(n_meek):
                send_blocking(q.producer(1), ("meek", i),
                              should_stop=stop.is_set)

        got_meek = []

        def consumer():
            while len(got_meek) < n_meek:
                status, item = q.try_recv()
                if status == nbb.OK and item[0] == "meek":
                    got_meek.append(item[1])

        threads = [threading.Thread(target=f) for f in (hog, meek, consumer)]
        for t in threads:
            t.start()
        threads[1].join(timeout=60)
        threads[2].join(timeout=60)
        stop.set()
        threads[0].join(timeout=10)
        assert got_meek == list(range(n_meek)), "meek producer starved"


# ---------------------------------------------------------------------------
# STATE channel recv path through the Transport protocol.
# ---------------------------------------------------------------------------
class TestStateTransport:
    def test_collision_then_retry_then_freshest(self):
        """Deterministic collision: a write-in-progress (odd version) maps
        to the transient Table-1 status; once the writer commits, recv
        returns the freshest committed value."""
        cell = nbw.HostNBW(depth=2)
        t = StateTransport(cell)
        assert t.try_recv() == (nbb.BUFFER_EMPTY, None)   # nothing published

        t.send("v1")
        t.send("v2")
        # Simulate a writer mid-publish exactly as HostNBW.write does:
        # bump the version to odd, write the buffer, don't commit yet.
        v = cell._version
        cell._version = v + 1
        status, payload = t.try_recv()
        assert status == nbb.BUFFER_EMPTY_BUT_PRODUCER_INSERTING  # -> spin
        assert payload is None
        # Writer commits; the retry observes the freshest value.
        cell._bufs[((v // 2) + 1) % cell._depth] = "v3"
        cell._version = v + 2
        assert t.try_recv() == (nbb.OK, "v3")
        # State semantics: re-reading the same value is legal.
        assert t.try_recv() == (nbb.OK, "v3")

    def test_recv_blocking_rides_out_collisions(self):
        cell = nbw.HostNBW(depth=2)
        t = StateTransport(cell)
        t.send(1)
        v = cell._version
        cell._version = v + 1                  # stuck mid-write...

        def commit():
            cell._bufs[((v // 2) + 1) % cell._depth] = 42
            cell._version = v + 2              # ...commits shortly after

        timer = threading.Timer(0.02, commit)
        timer.start()
        status, payload = recv_blocking(t, timeout_s=5)
        timer.join()
        assert (status, payload) == (nbb.OK, 42)

    def test_state_channel_through_domain(self):
        """End-to-end: STATE channel writer storm, reader sees monotone
        freshest values via the Transport recv path."""
        dom = Domain()
        ch = dom.connect(ChannelType.STATE, dom.create_endpoint(0, 5),
                         dom.create_endpoint(1, 5), nbw_depth=8)
        n = 5_000
        errors = []

        def writer():
            for i in range(1, n + 1):
                assert ch.send(i) == nbb.OK    # never blocks, never FULL

        def reader():
            last = 0
            while last < n:
                status, v = ch.recv()
                if status == nbb.OK:
                    if v < last:
                        errors.append((last, v))
                        return
                    last = v
        tw, tr = threading.Thread(target=writer), threading.Thread(target=reader)
        tr.start(); tw.start()
        tw.join(timeout=30); tr.join(timeout=30)
        assert not errors, errors[0]

    def test_state_drain_is_at_most_one_item(self):
        t = StateTransport(nbw.HostNBW(depth=2))
        assert t.drain() == []
        for i in range(5):
            t.send(i)
        assert t.drain() == [4]               # freshest only, not FIFO


# ---------------------------------------------------------------------------
# Backoff discipline + codec composition.
# ---------------------------------------------------------------------------
class TestBackoffAndCodec:
    def test_transient_spins_before_yield(self):
        import time as _time
        b = Backoff(spins=8, yields=4, sleep_init=1e-5, sleep_max=1e-4)
        t0 = _time.perf_counter()
        for _ in range(8):
            b.wait(nbb.BUFFER_EMPTY_BUT_PRODUCER_INSERTING)
        spin_t = _time.perf_counter() - t0
        assert spin_t < 0.05                  # pure spins: near-instant

    def test_sleep_is_bounded(self):
        b = Backoff(spins=0, yields=0, sleep_init=1e-5, sleep_max=5e-4)
        import time as _time
        t0 = _time.perf_counter()
        for _ in range(30):                   # would be 10s+ if unbounded
            b.wait(nbb.BUFFER_EMPTY)
        assert _time.perf_counter() - t0 < 1.0

    def test_send_blocking_timeout_on_full_ring(self):
        q = SpscQueue(1)
        assert q.send("x") == nbb.OK
        assert send_blocking(q, "y", timeout_s=0.05) is False
        assert q.drain() == ["x"]             # rejected payload not enqueued

    def test_recv_blocking_timeout_on_empty(self):
        status, payload = recv_blocking(SpscQueue(1), timeout_s=0.05)
        assert status == nbb.BUFFER_EMPTY and payload is None

    def test_codec_roundtrip_and_status_passthrough(self):
        t = CodecTransport(SpscQueue(2), encode=lambda x: x * 2,
                           decode=lambda x: x // 2)
        assert t.send(21) == nbb.OK
        assert t.send(5) == nbb.OK
        assert t.send(1) == nbb.BUFFER_FULL   # status passes through
        assert t.try_recv() == (nbb.OK, 21)
        assert t.drain() == [5]

    def test_generic_drain_helper(self):
        q = LockedQueue(8)
        for i in range(6):
            q.send(i)
        assert drain(q, max_items=4) == [0, 1, 2, 3]
        assert drain(q) == [4, 5]


# ---------------------------------------------------------------------------
# Packet-mode bursts (paper Tables 5-7): one counter pair per block.
# ---------------------------------------------------------------------------
class TestBurstOps:
    def test_partial_drain_leaves_remainder_in_order(self):
        q = SpscQueue(8)
        assert q.send_burst(list(range(6))) == (nbb.OK, 6)
        assert q.drain_burst(2) == [0, 1]
        assert q.drain_burst(3) == [2, 3, 4]
        # remainder still FIFO-composable with scalar ops
        assert q.try_recv() == (nbb.OK, 5)
        assert q.drain_burst(4) == []

    def test_full_ring_send_burst_refusal(self):
        q = SpscQueue(2)
        assert q.send_burst(["a", "b"]) == (nbb.OK, 2)
        status, n = q.send_burst(["c"])
        assert status == nbb.BUFFER_FULL and n == 0
        assert q.drain_burst() == ["a", "b"]    # nothing leaked in

    def test_partial_send_accepts_longest_prefix(self):
        q = SpscQueue(4)
        q.send("x")
        status, n = q.send_burst(list(range(5)))
        assert status == nbb.BUFFER_FULL and n == 3
        assert q.drain_burst() == ["x", 0, 1, 2]

    def test_burst_interops_with_scalar_ops(self):
        """Bursts and scalar insert/read share the same counters, so they
        interleave freely on one ring."""
        q = SpscQueue(8)
        q.send(0)
        assert q.send_burst([1, 2, 3]) == (nbb.OK, 3)
        assert q.try_recv() == (nbb.OK, 0)
        q.send(4)
        assert q.drain_burst() == [1, 2, 3, 4]

    def test_mpsc_drain_burst_preserves_per_producer_fifo(self):
        def script(m):
            q = m.MpscQueue(3, capacity_per_producer=8)
            sent = [q.producer(pid).send_burst([(pid, i) for i in range(4)])
                    for pid in range(3)]
            return sent, q.drain_burst()

        sent, got = _as_in_reference(script)
        assert sent == [(nbb.OK, 4)] * 3
        assert len(got) == 12
        for pid in range(3):
            assert [i for (p, i) in got if p == pid] == list(range(4))

    def test_locked_queue_burst_parity(self):
        """The mutex baseline speaks the same burst surface (A/B swaps
        stay caller-transparent)."""
        q = LockedQueue(4)
        assert q.send_burst([1, 2, 3, 4, 5]) == (nbb.BUFFER_FULL, 4)
        assert q.drain_burst(2) == [1, 2]
        assert q.send_burst([5]) == (nbb.OK, 1)
        assert q.drain_burst() == [3, 4, 5]

    def test_codec_burst_encodes_whole_block(self):
        t = CodecTransport(SpscQueue(8), encode=lambda x: x * 2,
                           decode=lambda x: x // 2)
        assert t.send_burst([1, 2, 3]) == (nbb.OK, 3)
        assert t.inner.drain_burst(1) == [2]    # encoded on the wire
        assert t.drain_burst() == [2, 3]

    def test_state_burst_keeps_freshest_only(self):
        t = StateTransport(nbw.HostNBW(depth=4))
        assert t.send_burst([1, 2, 3]) == (nbb.OK, 3)   # writes never block
        assert t.drain_burst() == [3]           # state semantics, not FIFO

    def _race(self, burst_sizes, capacity=8):
        """One producer sending bursts of the given sizes races one
        consumer draining bursts: every item arrives exactly once, in
        FIFO order, through spans that wrap the ring arbitrarily."""
        q = SpscQueue(capacity)
        total = sum(burst_sizes)
        got = []

        def producer():
            i = 0
            for size in burst_sizes:
                vals = list(range(i, i + size))
                while vals:
                    _, n = q.send_burst(vals)
                    vals = vals[n:]
                i += size

        def consumer():
            while len(got) < total:
                got.extend(q.drain_burst())

        # daemon: a lost-item bug must fail the assert, not hang the
        # interpreter at exit behind a spinning consumer thread
        ts = [threading.Thread(target=producer, daemon=True),
              threading.Thread(target=consumer, daemon=True)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts), "burst race livelocked"
        assert got == list(range(total)), "burst FIFO violated under race"

    def test_spsc_burst_race_deterministic(self):
        self._race([3, 8, 1, 5, 12, 2, 7, 9, 4, 6] * 20)

    if st is not None:

        @settings(max_examples=25, deadline=None)
        @given(sizes=st.lists(st.integers(min_value=1, max_value=12),
                              min_size=1, max_size=40),
               capacity=st.integers(min_value=1, max_value=9))
        def test_spsc_burst_race_property(self, sizes, capacity):
            """Hypothesis chooses the burst shapes and ring capacity; the
            exactly-once FIFO property must hold for all of them."""
            self._race(sizes, capacity=capacity)


# ---------------------------------------------------------------------------
# Non-blocking operation handles (MCAPI *_i / test / wait / cancel).
# ---------------------------------------------------------------------------
class TestOpHandle:
    def test_uncontended_send_completes_eagerly(self):
        q = SpscQueue(4)
        h = q.send_i("x")
        assert h.completed and h.done and not h.cancelled
        assert q.drain() == ["x"]

    def test_send_pending_on_full_then_polls_through(self):
        q = SpscQueue(1)
        assert q.send_i("a").completed
        h = q.send_i("b")
        assert not h.done and h.last_status == nbb.BUFFER_FULL
        assert h.test() is False            # still full
        assert q.try_recv() == (nbb.OK, "a")
        assert h.test() is True             # slot freed -> completes
        assert q.drain() == ["b"]

    def test_recv_pending_on_empty_then_wait(self):
        q = SpscQueue(2)
        h = q.recv_i()
        assert not h.done and h.last_status == nbb.BUFFER_EMPTY
        timer = threading.Timer(0.02, lambda: q.send(41))
        timer.start()
        assert h.wait(timeout_s=5) is True
        timer.join()
        assert h.result == 41

    def test_wait_timeout_leaves_handle_pending(self):
        """MCAPI wait with timeout: the op is NOT aborted — it can still
        be polled to completion or cancelled afterwards."""
        q = SpscQueue(2)
        h = q.recv_i()
        assert h.wait(timeout_s=0.02) is False
        assert h.state == states.OP_PENDING
        q.send("late")
        assert h.wait(timeout_s=1) is True and h.result == "late"

    def test_cancel_pending_recv(self):
        q = SpscQueue(2)
        h = q.recv_i()
        assert h.cancel() is True
        assert h.cancelled and h.cancel() is False
        q.send("x")
        assert h.test() is False            # cancelled handles never run
        assert h.wait(timeout_s=0.05) is False
        assert q.drain() == ["x"]           # the item was NOT consumed

    def test_cancel_after_completion_loses(self):
        q = SpscQueue(2)
        q.send(1)
        h = q.recv_i()                      # eager attempt completes
        assert h.completed
        assert h.cancel() is False          # exactly one terminal state
        assert h.completed and h.result == 1

    def test_exactly_one_terminal_state_under_race(self):
        """N cancellers race one poller over many rounds: every handle
        ends in exactly one terminal state, and an item consumed by a
        cancelled handle is parked in late_result, never lost."""
        for _ in range(200):
            q = SpscQueue(2)
            q.send("item")
            # raw OpHandle (no eager attempt), so the race is live
            h = OpHandle(q.try_recv, "race")
            results = []

            def poller():
                results.append(("poll", h.test()))

            def canceller():
                results.append(("cancel", h.cancel()))

            ts = [threading.Thread(target=f)
                  for f in (poller, canceller, canceller)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(10)
            assert h.state in (states.OP_COMPLETED, states.OP_CANCELLED)
            cancel_wins = sum(1 for k, r in results if k == "cancel" and r)
            if h.completed:
                assert cancel_wins == 0 and h.result == "item"
            else:
                assert cancel_wins == 1
                # if the poll's pop landed anyway, the item is parked
                if ("poll", False) in results and h.attempted_ok:
                    assert h.late_result == "item"

    def test_overlap_work_with_inflight_exchange(self):
        """The point of *_i: the caller issues the op, does other work,
        then collects — no retry loop at the call site."""
        q = SpscQueue(1)
        consumer_got = []

        def consumer():
            h = recv_i(q)
            while not h.test():
                pass                         # overlapped "work"
            consumer_got.append(h.result)

        t = threading.Thread(target=consumer)
        t.start()
        hs = send_i(q, "payload")
        assert hs.wait(timeout_s=5)
        t.join(10)
        assert consumer_got == ["payload"]

    def test_blocking_calls_are_handle_wrappers(self):
        """send_blocking/recv_blocking are layered over handle + wait."""
        import inspect
        src = (inspect.getsource(transport.send_blocking)
               + inspect.getsource(transport.recv_blocking))
        assert "send_i" in src and "recv_i" in src and ".wait(" in src

    def test_handles_on_every_transport(self):
        dom = Domain()
        scalar = dom.connect(ChannelType.SCALAR, dom.create_endpoint(0, 11),
                             dom.create_endpoint(1, 11))
        for t in (SpscQueue(4), LockedQueue(4), scalar.transport):
            assert t.send_i(3).completed
            h = t.recv_i()
            assert h.completed and h.result == 3
        mp = MpscQueue(2)
        mp.producer(1).send("m")
        assert mp.recv_i().result == "m"

    def test_channel_typed_variants_enforce_format(self):
        dom = Domain()
        msg = dom.connect(ChannelType.MESSAGE, dom.create_endpoint(0, 12),
                          dom.create_endpoint(1, 12))
        pkt = dom.connect(ChannelType.PACKET, dom.create_endpoint(0, 13),
                          dom.create_endpoint(1, 13))
        sca = dom.connect(ChannelType.SCALAR, dom.create_endpoint(0, 14),
                          dom.create_endpoint(1, 14))
        assert msg.msg_send_i({"k": 1}).completed
        assert msg.msg_recv_i().result == {"k": 1}
        assert pkt.pkt_send_i(b"bytes").completed
        assert pkt.pkt_recv_i().result == b"bytes"
        assert sca.scalar_send_i(-7).completed
        assert sca.scalar_recv_i().result == -7
        with pytest.raises(ValueError):
            msg.pkt_send_i(b"wrong format")
        with pytest.raises(ValueError):
            sca.msg_recv_i()
        with pytest.raises(ValueError):
            pkt.scalar_send_i(1)

    def test_message_priority_fifo(self):
        """MESSAGE delivery is priority FIFO, as the format documents
        (satellite of DESIGN.md §12): lower class number drains first,
        FIFO within a class, unprioritized sends land least urgent."""
        def script(m, lock_free):
            dom = m.Domain(lock_free=lock_free)
            msg = dom.connect(m.ChannelType.MESSAGE,
                              dom.create_endpoint(0, 20),
                              dom.create_endpoint(1, 20))
            sends = [msg.msg_send("n1", priority=1),
                     msg.send("plain"),                 # least urgent
                     msg.msg_send("h1", priority=0),
                     msg.msg_send_i("h2", priority=0).completed,
                     msg.msg_send("n2", priority=1)]
            return sends, [msg.recv()[1] for _ in range(5)], msg.recv()

        for lock_free in (True, False):
            sends, got, last = _as_in_reference(
                lambda m: script(m, lock_free))
            assert sends == [nbb.OK, nbb.OK, nbb.OK, True, nbb.OK]
            assert got == ["h1", "h2", "n1", "n2", "plain"]
            assert last == (nbb.BUFFER_EMPTY, None)

    def test_message_priority_clamped_and_bursts(self):
        dom = Domain(msg_priorities=2)
        msg = dom.connect(ChannelType.MESSAGE, dom.create_endpoint(0, 21),
                          dom.create_endpoint(1, 21))
        assert msg.msg_send("deep", priority=99) == nbb.OK   # clamps to 1
        assert msg.msg_send("top", priority=0) == nbb.OK
        # drain_burst serves whole classes in priority order
        assert msg.drain_burst() == ["top", "deep"]
        with pytest.raises(ValueError):
            Domain(msg_priorities=0)

    def test_priority_transport_transient_status(self):
        """A mid-insert producer in ANY class surfaces the transient
        empty status so the consumer spins instead of sleeping; a
        committed item in a less urgent class still drains through it."""
        from repro_torch.core.transport import PriorityTransport
        rings = [SpscQueue(4), SpscQueue(4)]
        tp = PriorityTransport(rings)
        assert tp.try_recv() == (nbb.BUFFER_EMPTY, None)
        rings[1].insert_item("low")
        rings[0]._uc += 1               # class-0 announced, not committed
        status, item = tp.try_recv()
        assert status == nbb.OK and item == "low"   # committed wins now
        assert tp.try_recv()[0] == nbb.BUFFER_EMPTY_BUT_PRODUCER_INSERTING

