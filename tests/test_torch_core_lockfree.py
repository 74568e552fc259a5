"""Port counterpart of ``tests/test_core_lockfree.py``: the lock-free
core of ``repro_torch`` (NBB, NBW, bitset, refcounts, FSMs, queues).

Validates the paper's three design properties (Section 3) on the port:
  Safety       — a successful read never returns a corrupted value,
  Timeliness   — failed ops return immediately with a status (bounded retry),
  Non-blocking — the writer is never blocked by readers and vice versa.

Six cases are held on both packages by ``tests/test_torch_core.py``
and are not copied here (reference name -> that file's name):
  TestHostNBB.test_fifo_order -> test_hostnbb_fifo_and_full_empty
  TestHostNBB.test_wraparound -> test_hostnbb_wraparound
  TestHostNBBThreaded.test_spsc_transaction_ids_in_order
      -> test_hostnbb_spsc_threads_in_order
  TestStateMachines.test_racing_threads_single_winner
      -> test_fsm_racing_threads_single_winner
  TestStateMachines.test_journal_compaction_preserves_state (same name)
  TestQueuesAndChannels.test_mpsc_fan_in
      -> test_mpsc_fan_in_keeps_per_producer_fifo

Threaded races run on the port alone.  The functional forms (the
reference's ``jnp`` NBB, NBW and bit set; here torch tensors threaded
through a Python loop, where the reference jits them or carries them
through ``lax.scan``) are held to the reference's functions on the same
op sequence: statuses equal and values exactly equal.
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:  # optional dev dependency (requirements-dev.txt); property tests
    from hypothesis import given, settings, strategies as st  # skip without it
except ImportError:
    given = settings = st = None

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import bitset as jbitset  # noqa: E402
from repro.core import nbb as jnbb  # noqa: E402
from repro.core import nbw as jnbw  # noqa: E402
from repro_torch.core import bitset, nbb, nbw, states  # noqa: E402
from repro_torch.core.channels import ChannelType, Domain  # noqa: E402
from repro_torch.core.host_queue import LockedQueue  # noqa: E402
from repro_torch.core.nbb import HostNBB, SimNBB  # noqa: E402
from repro_torch.core.refcount import RefCountArray  # noqa: E402


def _i32(v):
    return torch.tensor(v, dtype=torch.int32)


def _run_nbb(mod, scalar, capacity, ops):
    """An insert (True) / read (False) sequence through a functional NBB
    (the port's ``mod`` with torch scalars, or the reference's with jnp
    ones); inserts carry 0, 1, ... as they succeed.
    -> [(status, item read or None, size after)]."""
    s = mod.init(capacity, scalar(0))
    out, nxt = [], 0
    for is_insert in ops:
        item = None
        if is_insert:
            s, status = mod.insert_item(s, scalar(nxt))
            nxt += int(status) == mod.OK
        else:
            s, got, status = mod.read_item(s)
            item = int(got)
        out.append((int(status), item, int(mod.size(s))))
    return out


# ---------------------------------------------------------------------------
# HostNBB — single-threaded semantics
# ---------------------------------------------------------------------------
class TestHostNBB:
    def test_len(self):
        q = HostNBB(4)
        assert len(q) == 0
        q.insert_item(1)
        q.insert_item(2)
        assert len(q) == 2
        q.read_item()
        assert len(q) == 1

    def test_capacity_one(self):
        q = HostNBB(1)
        assert q.insert_item("x") == nbb.OK
        assert q.insert_item("y") == nbb.BUFFER_FULL
        assert q.read_item() == (nbb.OK, "x")


# ---------------------------------------------------------------------------
# HostNBB — real two-thread stress (the paper's stress-test design, §4:
# transaction IDs 1..1000 verified in sequence at the receiver).
# ---------------------------------------------------------------------------
class TestHostNBBThreaded:
    def test_multi_payload_types(self):
        """message/packet/scalar payloads all travel uncorrupted."""
        q = HostNBB(8)
        payloads = [b"m" * 24, ("packet", bytes(24)), 0xDEADBEEF]
        done = []

        def producer():
            for p in payloads * 100:
                q.put(p)

        def consumer():
            for _ in range(len(payloads) * 100):
                done.append(q.get())

        t1, t2 = threading.Thread(target=producer), threading.Thread(target=consumer)
        t1.start(); t2.start(); t1.join(30); t2.join(30)
        assert done == payloads * 100


# ---------------------------------------------------------------------------
# Functional JAX NBB
# ---------------------------------------------------------------------------
class TestJaxNBB:
    """The port's functional NBB (``core/nbb.py`` ``NBBState``) on torch
    tensors, against the reference's ``jnp`` functions."""

    def test_fifo_roundtrip_jit(self):
        def run(mod, full, zeros):
            s = mod.init(4, zeros)
            outs, statuses = [], []
            for i in range(4):
                s, st_ = mod.insert_item(s, full(float(i)))
                statuses.append(st_)
            s, st_full = mod.insert_item(s, full(9.0))
            for _ in range(4):
                s, item, st_ = mod.read_item(s)
                outs.append(item)
            _, _, st_empty = mod.read_item(s)
            return outs, statuses + [st_full, st_empty]

        outs, statuses = run(nbb, lambda v: torch.full((3,), v),
                             torch.zeros(3))
        statuses = [int(x) for x in statuses]
        want_outs, want_statuses = jax.jit(lambda: run(
            jnbb, lambda v: jnp.full((3,), v),
            jnp.zeros((3,), jnp.float32)))()
        for i, (o, w) in enumerate(zip(outs, want_outs)):
            np.testing.assert_array_equal(o.numpy(),
                                          np.full(3, i, np.float32))
            np.testing.assert_array_equal(o.numpy(), np.asarray(w))
        assert statuses == [int(x) for x in want_statuses]
        assert statuses == [nbb.OK] * 4 + [nbb.BUFFER_FULL, nbb.BUFFER_EMPTY]

    def test_full_insert_is_noop(self):
        def run(mod, scalar):
            s = mod.init(1, scalar(0))
            s, _ = mod.insert_item(s, scalar(7))
            s2, status = mod.insert_item(s, scalar(8))
            _, item, _ = mod.read_item(s2)
            return int(status), int(item)

        got = run(nbb, _i32)
        assert got == run(jnbb, jnp.int32)
        assert got == (nbb.BUFFER_FULL, 7), "full insert must not overwrite"

    def test_usable_as_scan_carry(self):
        """The reference carries the state through ``lax.scan``; the port
        threads it through a Python loop (no host read inside)."""
        s = nbb.init(2, torch.zeros(()))
        ys = []
        for x in torch.arange(10, dtype=torch.float32):
            s, _ = nbb.insert_item(s, x)
            s, item, _ = nbb.read_item(s)
            ys.append(item)

        def body(c, x):
            c, _ = jnbb.insert_item(c, x)
            c, item, _ = jnbb.read_item(c)
            return c, item

        _, want = jax.lax.scan(body, jnbb.init(2, jnp.zeros((), jnp.float32)),
                               jnp.arange(10, dtype=jnp.float32))
        np.testing.assert_array_equal(torch.stack(ys).numpy(),
                                      np.asarray(want))
        np.testing.assert_array_equal(torch.stack(ys).numpy(),
                                      np.arange(10, dtype=np.float32))


# ---------------------------------------------------------------------------
# NBW
# ---------------------------------------------------------------------------
class TestNBW:
    def test_host_roundtrip(self):
        w = nbw.HostNBW(depth=2)
        for v in range(20):
            w.write(v)
            assert w.read() == v
        assert w.version == 20

    def test_reader_sees_latest_not_order(self):
        w = nbw.HostNBW(depth=4)
        w.write("a"); w.write("b"); w.write("c")
        assert w.read() == "c"  # state messages: latest wins

    def test_threaded_no_corruption(self):
        """Readers under a writer storm never observe torn values.

        Values are (i, i*i) pairs; a torn read would mismatch the pair."""
        w = nbw.HostNBW(depth=2)
        w.write((0, 0))
        stop = threading.Event()
        bad = []

        def writer():
            i = 0
            while not stop.is_set():
                w.write((i, i * i))
                i += 1

        def reader():
            for _ in range(20000):
                i, sq = w.read()
                if sq != i * i:
                    bad.append((i, sq))

        wt = threading.Thread(target=writer)
        rts = [threading.Thread(target=reader) for _ in range(2)]
        wt.start(); [t.start() for t in rts]
        [t.join(60) for t in rts]
        stop.set(); wt.join(10)
        assert not bad, f"torn NBW reads: {bad[:3]}"

    def test_jax_functional(self):
        s = nbw.init(2, torch.zeros(4))
        js = jnbw.init(2, jnp.zeros((4,), jnp.float32))
        for v in range(5):
            s = nbw.write(s, torch.full((4,), float(v)))
            js = jnbw.write(js, jnp.full((4,), float(v)))
            value, version = nbw.read(s)
            want_value, want_version = jnbw.read(js)
            np.testing.assert_array_equal(value.numpy(),
                                          np.asarray(want_value))
            np.testing.assert_array_equal(value.numpy(),
                                          np.full(4, v, np.float32))
            assert int(version) == int(want_version) == v + 1


# ---------------------------------------------------------------------------
# Bitset
# ---------------------------------------------------------------------------
class TestBitset:
    def test_host_claim_release(self):
        b = bitset.HostBitset(4)
        got = [b.try_claim(f"o{i}") for i in range(4)]
        assert sorted(got) == [0, 1, 2, 3]
        assert b.try_claim("x") is None
        b.release(2)
        assert b.try_claim("y") == 2

    def test_host_threaded_unique_claims(self):
        """N threads racing for slots never double-claim (CAS property)."""
        b = bitset.HostBitset(64)
        claims = [[] for _ in range(8)]

        def worker(tid):
            while True:
                s = b.try_claim(owner=(tid, len(claims[tid])))
                if s is None:
                    return
                claims[tid].append(s)

        ts = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
        [t.start() for t in ts]; [t.join(30) for t in ts]
        all_claims = [s for c in claims for s in c]
        assert sorted(all_claims) == list(range(64)), "double-claimed slots"

    def test_jax_claim_release_full(self):
        def run(mod, scalar):
            bits = mod.init(5)
            slots = []
            for _ in range(6):          # the sixth finds the set full
                bits, slot = mod.claim_first_free(bits, 5)
                slots.append(int(slot))
            bits = mod.release(bits, scalar(3))
            freed = bool(mod.is_claimed(bits, scalar(3)))
            bits, slot = mod.claim_first_free(bits, 5)
            return slots, freed, int(slot), int(mod.count(bits))

        got = run(bitset, _i32)
        assert got == run(jbitset, jnp.int32)
        # full: non-blocking failure (-1); the released slot is reclaimed
        assert got == ([0, 1, 2, 3, 4, -1], False, 3, 5)


# ---------------------------------------------------------------------------
# RefCountArray — the bitset's refcounted generalization (shared KV pages)
# ---------------------------------------------------------------------------
class TestRefCount:
    def test_claim_share_release_lifecycle(self):
        r = RefCountArray(4)
        assert r.try_claim() == 0
        assert r.refcount(0) == 1
        assert r.incref(0) == 2          # fetch-add share
        assert r.decref(0) == 1          # fetch-sub release
        assert r.is_claimed(0)
        assert r.decref(0) == 0          # last ref: back to the free set
        assert not r.is_claimed(0)
        assert r.try_claim() == 0        # immediately claimable again

    def test_free_slot_refuses_share_and_release(self):
        """incref requires a holder; decref without a reference is a bug,
        not a silent no-op — both raise instead of corrupting the count."""
        r = RefCountArray(2)
        with pytest.raises(KeyError):
            r.incref(1)
        with pytest.raises(KeyError):
            r.decref(1)

    def test_claim_specific_only_from_zero(self):
        r = RefCountArray(2)
        assert r.claim_specific(1) is True
        assert r.claim_specific(1) is False   # held: CAS fails
        r.incref(1)
        r.decref(1)
        assert r.claim_specific(1) is False   # still held (count 1)
        r.decref(1)
        assert r.claim_specific(1) is True    # free again

    def test_full_pool_returns_none(self):
        r = RefCountArray(3)
        assert sorted(r.try_claim() for _ in range(3)) == [0, 1, 2]
        assert r.try_claim() is None          # non-blocking failure
        r.release(1)                          # HostBitset-compatible alias
        assert r.try_claim() == 1

    def test_counts(self):
        r = RefCountArray(4)
        r.try_claim()
        r.try_claim()
        r.incref(0)
        assert r.count() == 2                 # held slots, counted once
        assert r.shared_count() == 1          # only slot 0 is shared
        assert r.refcount(0) == 2 and r.refcount(1) == 1

    def test_claim_from_zero_single_winner_threaded(self):
        """Claim-from-zero is the one transition needing mutual exclusion
        between claimers: N threads racing for the same free slot yield
        exactly one winner, and the slot returns to the free set exactly
        once per release (no double-claim ever observed across rounds)."""
        r = RefCountArray(1)
        for _round in range(50):
            wins = []
            barrier = threading.Barrier(4)

            def claimer():
                barrier.wait()
                if r.claim_specific(0):
                    wins.append(1)

            ts = [threading.Thread(target=claimer) for _ in range(4)]
            [t.start() for t in ts]
            [t.join(10) for t in ts]
            assert len(wins) == 1, f"{len(wins)} CAS winners"
            assert r.refcount(0) == 1
            assert r.decref(0) == 0

    def test_shared_slot_incref_decref_storm(self):
        """incref/decref from many threads on one shared slot never lose
        an update (the fetch-add/fetch-sub property): with the base
        reference pinned, the count comes back to exactly 1 after the
        storm, and the slot never transiently frees (claim_specific by a
        rival must fail throughout)."""
        r = RefCountArray(1)
        assert r.try_claim() == 0            # base ref pinned by the test
        stolen = []
        stop = threading.Event()

        def churner():
            for _ in range(5000):
                r.incref(0)
                r.decref(0)

        def thief():
            while not stop.is_set():
                if r.claim_specific(0):      # only possible at count 0
                    stolen.append(1)
                    r.decref(0)

        ts = [threading.Thread(target=churner) for _ in range(4)]
        tt = threading.Thread(target=thief)
        [t.start() for t in ts]
        tt.start()
        [t.join(60) for t in ts]
        stop.set()
        tt.join(10)
        assert not stolen, "slot freed while referenced"
        assert r.refcount(0) == 1, "lost incref/decref update"


# ---------------------------------------------------------------------------
# State machines (paper Figures 3 & 4)
# ---------------------------------------------------------------------------
class TestStateMachines:
    def test_request_lifecycle(self):
        c = states.request_cell()
        c.transition(states.REQUEST_FREE, states.REQUEST_VALID)
        c.transition(states.REQUEST_VALID, states.REQUEST_RECEIVED)
        c.transition(states.REQUEST_RECEIVED, states.REQUEST_COMPLETED)
        c.transition(states.REQUEST_COMPLETED, states.REQUEST_FREE)
        assert c.state == states.REQUEST_FREE

    def test_cancel_path(self):
        c = states.request_cell()
        c.transition(states.REQUEST_FREE, states.REQUEST_VALID)
        c.transition(states.REQUEST_VALID, states.REQUEST_CANCELLED)
        c.transition(states.REQUEST_CANCELLED, states.REQUEST_FREE)

    def test_illegal_transition_raises(self):
        c = states.request_cell()
        with pytest.raises(states.IllegalTransition):
            c.cas(states.REQUEST_FREE, states.REQUEST_COMPLETED)

    def test_cas_loser_detected(self):
        c = states.request_cell()
        assert c.cas(states.REQUEST_FREE, states.REQUEST_VALID) is True
        assert c.cas(states.REQUEST_FREE, states.REQUEST_VALID) is False

    def test_buffer_lifecycle(self):
        c = states.buffer_cell()
        for a, b in [(states.BUFFER_FREE, states.BUFFER_RESERVED),
                     (states.BUFFER_RESERVED, states.BUFFER_ALLOCATED),
                     (states.BUFFER_ALLOCATED, states.BUFFER_RECEIVED),
                     (states.BUFFER_RECEIVED, states.BUFFER_FREE)]:
            c.transition(a, b)
        assert c.state == states.BUFFER_FREE

    def test_buffer_preempt_resume_cycle(self):
        """Figure-4 extension (DESIGN.md §12): ALLOCATED -> PREEMPTED
        parks a swapped-out sequence; PREEMPTED -> ALLOCATED resumes
        it; PREEMPTED -> FREE is cancel-while-parked."""
        c = states.buffer_cell()
        c.transition(states.BUFFER_FREE, states.BUFFER_RESERVED)
        c.transition(states.BUFFER_RESERVED, states.BUFFER_ALLOCATED)
        c.transition(states.BUFFER_ALLOCATED, states.BUFFER_PREEMPTED)
        c.transition(states.BUFFER_PREEMPTED, states.BUFFER_ALLOCATED)
        c.transition(states.BUFFER_ALLOCATED, states.BUFFER_RECEIVED)
        c.transition(states.BUFFER_RECEIVED, states.BUFFER_FREE)
        assert c.state == states.BUFFER_FREE
        # cancel-while-parked path
        c.transition(states.BUFFER_FREE, states.BUFFER_RESERVED)
        c.transition(states.BUFFER_RESERVED, states.BUFFER_ALLOCATED)
        c.transition(states.BUFFER_ALLOCATED, states.BUFFER_PREEMPTED)
        c.transition(states.BUFFER_PREEMPTED, states.BUFFER_FREE)
        assert c.state == states.BUFFER_FREE

    def test_buffer_preempt_illegal_edges(self):
        """Only an ALLOCATED (fully prefilled) sequence can park, and a
        parked one cannot retire without resuming first."""
        c = states.buffer_cell()
        c.transition(states.BUFFER_FREE, states.BUFFER_RESERVED)
        with pytest.raises(states.IllegalTransition):
            c.cas(states.BUFFER_RESERVED, states.BUFFER_PREEMPTED)
        c.transition(states.BUFFER_RESERVED, states.BUFFER_ALLOCATED)
        c.transition(states.BUFFER_ALLOCATED, states.BUFFER_PREEMPTED)
        with pytest.raises(states.IllegalTransition):
            c.cas(states.BUFFER_PREEMPTED, states.BUFFER_RECEIVED)
        # racing resume vs cancel-while-parked: exactly one CAS wins
        assert c.cas(states.BUFFER_PREEMPTED, states.BUFFER_ALLOCATED)
        assert not c.cas(states.BUFFER_PREEMPTED, states.BUFFER_FREE)

# ---------------------------------------------------------------------------
# MPSC composition + MCAPI channel API
# ---------------------------------------------------------------------------
class TestQueuesAndChannels:
    def test_locked_queue_baseline_semantics(self):
        q = LockedQueue(2)
        assert q.insert_item(1) == nbb.OK
        assert q.insert_item(2) == nbb.OK
        assert q.insert_item(3) == nbb.BUFFER_FULL
        assert q.read_item() == (nbb.OK, 1)

    @pytest.mark.parametrize("lock_free", [True, False])
    def test_mcapi_channel_roundtrip(self, lock_free):
        dom = Domain(lock_free=lock_free, queue_capacity=8)
        tx = dom.create_endpoint(node=1, port=0)
        for ctype, payload in [
            (ChannelType.MESSAGE, b"hello" * 5),
            (ChannelType.PACKET, bytes(24)),
            (ChannelType.SCALAR, -12345678901),
        ]:
            ch = dom.connect(ctype, tx, dom.create_endpoint(2, hash(ctype.value) % 1000 + 1))
            ch.send_blocking(payload)
            assert ch.recv_blocking() == payload

    def test_scalar_widths(self):
        dom = Domain()
        ch = dom.connect(ChannelType.SCALAR, dom.create_endpoint(0, 1),
                         dom.create_endpoint(0, 2))
        for v in [0, 255, 2 ** 15 - 1, -2 ** 31, 2 ** 63 - 1]:
            ch.send_blocking(v)
            assert ch.recv_blocking() == v


# ---------------------------------------------------------------------------
# Property tests (hypothesis): interleaving simulator proves Safety under
# ANY schedule; functional NBB matches a bounded-FIFO reference model.
# Defined only when hypothesis is installed; otherwise one skip records it.
# ---------------------------------------------------------------------------
if st is None:
    def test_hypothesis_property_tests():
        pytest.importorskip("hypothesis")   # records the skip with reason
else:
    class TestNBBInterleavings:
        @given(
            capacity=st.integers(1, 4),
            schedule=st.lists(st.booleans(), min_size=1, max_size=60),
        )
        @settings(max_examples=300, deadline=None)
        def test_no_torn_reads_any_interleaving(self, capacity, schedule):
            """Under any producer/consumer interleaving of the micro-ops, a
            committed read never observes a torn slot, and FIFO order holds."""
            sim = SimNBB(capacity)
            p_state, c_state = "idle", "idle"
            next_val, expect = 1, 1
            for is_producer in schedule:
                if is_producer:
                    if p_state == "idle":
                        if sim.try_begin_insert() == nbb.OK:
                            sim.write_half(next_val)  # torn intermediate
                            p_state = "mid"
                    else:
                        sim.write_commit(next_val)
                        next_val += 1
                        p_state = "idle"
                else:
                    if c_state == "idle":
                        if sim.try_begin_read() == nbb.OK:
                            c_state = "mid"
                    else:
                        value, torn = sim.read_commit()
                        assert torn == 0, "SAFETY VIOLATION: torn read"
                        assert value == expect, "FIFO order violated"
                        expect += 1
                        c_state = "idle"

        @given(capacity=st.integers(1, 4))
        @settings(max_examples=50, deadline=None)
        def test_status_codes_match_table1(self, capacity):
            sim = SimNBB(capacity)
            # Fill the ring completely.
            for v in range(capacity):
                assert sim.try_begin_insert() == nbb.OK
                sim.write_commit(v)
            assert sim.try_begin_insert() == nbb.BUFFER_FULL
            # Start (but don't finish) a read: producer must see the
            # "consumer reading" variant -> spin, don't yield.
            assert sim.try_begin_read() == nbb.OK
            assert (sim.try_begin_insert()
                    == nbb.BUFFER_FULL_BUT_CONSUMER_READING)
            sim.read_commit()
            # Drain the rest.
            for _ in range(capacity - 1):
                assert sim.try_begin_read() == nbb.OK
                sim.read_commit()
            assert sim.try_begin_read() == nbb.BUFFER_EMPTY
            # Start (but don't finish) an insert: consumer sees the
            # "producer inserting" variant.
            assert sim.try_begin_insert() == nbb.OK
            sim.write_half(123)
            assert (sim.try_begin_read()
                    == nbb.BUFFER_EMPTY_BUT_PRODUCER_INSERTING)

    class TestJaxNBBProperties:
        @given(
            capacity=st.integers(1, 5),
            ops=st.lists(st.booleans(), min_size=1, max_size=40),
        )
        @settings(max_examples=100, deadline=None)
        def test_matches_reference_fifo(self, capacity, ops):
            """The functional NBB behaves exactly like a bounded FIFO, and
            exactly like the reference's on the same op sequence."""
            got = _run_nbb(nbb, _i32, capacity, ops)
            assert got == _run_nbb(jnbb, jnp.int32, capacity, ops)
            model: list = []
            next_val = 0
            for is_insert, (status, item, size) in zip(ops, got):
                if is_insert:
                    if len(model) < capacity:
                        assert status == nbb.OK
                        model.append(next_val)
                        next_val += 1
                    else:
                        assert status == nbb.BUFFER_FULL
                else:
                    if model:
                        assert status == nbb.OK
                        assert item == model.pop(0)
                    else:
                        assert status == nbb.BUFFER_EMPTY
                assert size == len(model)

    class TestBitsetProperties:
        @given(n=st.integers(1, 100))
        @settings(max_examples=30, deadline=None)
        def test_jax_count_matches(self, n):
            def run(mod):
                bits = mod.init(n)
                k = min(n, 7)
                slots = []
                for _ in range(k):
                    bits, slot = mod.claim_first_free(bits, n)
                    slots.append(int(slot))
                return slots, int(mod.count(bits))

            got = run(bitset)
            assert got == run(jbitset)
            assert got[1] == min(n, 7)

        @given(
            nslots=st.integers(4, 48),
            n_threads=st.integers(2, 5),
            ops=st.integers(5, 40),
            starts=st.lists(st.integers(0, 47), min_size=5, max_size=5),
        )
        @settings(max_examples=25, deadline=None)
        def test_host_bitset_claim_release_race_never_double_allocates(
                self, nslots, n_threads, ops, starts):
            """The page-allocator Safety property under REAL thread races
            (DESIGN.md §10 relies on it: a double-allocated page would
            hand one KV page to two sequences).  Each thread hammers
            claim/release from a hypothesis-chosen probe start; at every
            claim it checks the slot was not already held by anyone, and
            at the barrier all held sets must be disjoint and the free
            count exact."""
            b = bitset.HostBitset(nslots)
            holders = [set() for _ in range(n_threads)]
            violations: list = []
            barrier = threading.Barrier(n_threads)

            def worker(tid):
                mine = holders[tid]
                barrier.wait()
                for i in range(ops):
                    slot = b.try_claim(owner=object(),
                                       start=starts[tid % len(starts)]
                                       % nslots)
                    if slot is not None:
                        if slot in mine:
                            violations.append(("self-dup", tid, slot))
                        mine.add(slot)
                    # release roughly half of what we hold, keep churning
                    if mine and i % 2:
                        b.release(mine.pop())

            threads = [threading.Thread(target=worker, args=(t,))
                       for t in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            assert not violations, violations
            seen: set = set()
            for mine in holders:
                assert not (mine & seen), "double-allocated page"
                seen |= mine
            assert b.count() == len(seen)
            for s in seen:          # full cleanup releases every claim
                b.release(s)
            assert b.count() == 0

    class TestRefCountProperties:
        @given(
            nslots=st.integers(2, 32),
            n_threads=st.integers(2, 5),
            ops=st.integers(5, 60),
            starts=st.lists(st.integers(0, 47), min_size=5, max_size=5),
        )
        @settings(max_examples=25, deadline=None)
        def test_share_release_claim_race_counts_exact(
                self, nslots, n_threads, ops, starts):
            """The shared-page allocator Safety property under REAL
            thread races (DESIGN.md §11 relies on it: a count drift
            would either free a KV page some sequence still attends or
            leak it forever).  Each thread hammers claim-from-zero,
            share (incref of slots it holds) and release from a
            hypothesis-chosen probe start; after the join every slot's
            count must equal the references the threads still hold —
            exactly — and draining those returns every slot to the free
            set exactly once (each becomes claimable again, count 0)."""
            r = RefCountArray(nslots)
            held = [{} for _ in range(n_threads)]   # tid -> {slot: refs}
            violations: list = []
            barrier = threading.Barrier(n_threads)

            def worker(tid):
                mine = held[tid]
                barrier.wait()
                for i in range(ops):
                    if i % 3 == 0 and mine:          # share what we hold
                        s = next(iter(mine))
                        if r.incref(s) < 2:
                            violations.append(("count<2 after share",
                                               tid, s))
                        mine[s] += 1
                    else:
                        s = r.try_claim(start=starts[tid % len(starts)]
                                        % nslots)
                        if s is not None:
                            mine[s] = mine.get(s, 0) + 1
                    if mine and i % 2:               # release one ref
                        s = next(iter(mine))
                        r.decref(s)
                        mine[s] -= 1
                        if not mine[s]:
                            del mine[s]

            threads = [threading.Thread(target=worker, args=(t,))
                       for t in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            assert not violations, violations
            # Counts exact after the join: allocator count == sum of the
            # references the threads actually kept, slot by slot.
            totals = [0] * nslots
            for mine in held:
                for s, k in mine.items():
                    totals[s] += k
            for s in range(nslots):
                assert r.refcount(s) == totals[s], (
                    f"slot {s}: count {r.refcount(s)} != held {totals[s]}")
            assert r.count() == sum(1 for t in totals if t)
            # Exactly-once return to the free set: draining every held
            # reference frees every slot (no zombie refs, no early free).
            for s, k in enumerate(totals):
                for j in range(k):
                    assert r.decref(s) == k - j - 1
            assert r.count() == 0
            for s in range(nslots):
                assert r.claim_specific(s), "slot not returned to free set"
