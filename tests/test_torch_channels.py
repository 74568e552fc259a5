"""The port's MCAPI channels and bit set (``repro_torch.core.channels``,
``repro_torch.core.bitset``): counterparts of ``test_channels_state.py``,
the channel cases of ``test_core_lockfree.py`` and ``test_transport.py``,
and its ``TestBitset``.  The functional bit set runs on torch tensors and
is held against the JAX package's on the same claim/release sequences:
the same slots, the same -1 when full, the same counts."""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import bitset as jbitset  # noqa: E402
from repro_torch.core import bitset, nbb, states  # noqa: E402
from repro_torch.core.channels import (ChannelType, DeviceChannel,  # noqa: E402
                                       Domain)
from repro_torch.core.host_queue import BroadcastChannel  # noqa: E402


# ---------------------------------------------------------------------------
# STATE (NBW) channels and the broadcast composition
# ---------------------------------------------------------------------------
def test_state_channel_freshest_wins():
    dom = Domain()
    a, b = dom.create_endpoint(0, 1), dom.create_endpoint(1, 1)
    ch = dom.connect(ChannelType.STATE, a, b)
    assert ch.recv() == (nbb.BUFFER_EMPTY, None)
    for i in range(10):
        assert ch.send(i) == nbb.OK        # writer never blocks
    assert ch.recv() == (nbb.OK, 9)        # newest value, not FIFO head
    assert ch.recv() == (nbb.OK, 9)        # state re-read is legal


def test_state_channel_never_fills():
    dom = Domain(queue_capacity=2)
    ch = dom.connect(ChannelType.STATE, dom.create_endpoint(0, 2),
                     dom.create_endpoint(1, 2))
    for i in range(1000):
        assert ch.send(i) == nbb.OK
    assert ch.recv() == (nbb.OK, 999)


def test_state_channel_threaded_monotone_reads():
    """Readers may skip values but never see them go backwards."""
    dom = Domain()
    ch = dom.connect(ChannelType.STATE, dom.create_endpoint(0, 3),
                     dom.create_endpoint(1, 3), nbw_depth=8)
    n, errors = 20_000, []

    def writer():
        for i in range(1, n + 1):
            ch.send(i)

    def reader():
        last = 0
        while last < n:
            status, v = ch.recv()
            if status == nbb.OK and v is not None:
                if v < last:
                    errors.append((last, v))
                    return
                last = v

    tw, tr = threading.Thread(target=writer), threading.Thread(target=reader)
    tr.start()
    tw.start()
    tw.join()
    tr.join(timeout=30)
    assert not errors, errors[0]


def test_state_channel_recv_i_handle():
    dom = Domain()
    ch = dom.connect(ChannelType.STATE, dom.create_endpoint(0, 7),
                     dom.create_endpoint(1, 7))
    h = ch.recv_i()
    assert not h.done and h.last_status == nbb.BUFFER_EMPTY
    assert h.test() is False
    for i in range(5):
        assert ch.send(i) == nbb.OK
    assert h.test() is True
    assert h.completed and h.result == 4
    assert h.test() is True
    h2 = ch.recv_i()
    assert h2.completed and h2.result == 4


def test_state_channel_recv_i_rides_out_write_collision():
    dom = Domain()
    ch = dom.connect(ChannelType.STATE, dom.create_endpoint(0, 8),
                     dom.create_endpoint(1, 8))
    cell = ch.queue
    cell.write("v0")
    v = cell._version
    cell._version = v + 1                  # writer stuck mid-publish
    h = ch.recv_i()
    assert not h.done
    assert h.last_status == nbb.BUFFER_EMPTY_BUT_PRODUCER_INSERTING

    def commit():
        cell._bufs[((v // 2) + 1) % cell._depth] = "v1"
        cell._version = v + 2

    timer = threading.Timer(0.02, commit)
    timer.start()
    assert h.wait(timeout_s=5) is True
    timer.join()
    assert h.result == "v1"


def test_state_channel_recv_i_cancel():
    dom = Domain()
    ch = dom.connect(ChannelType.STATE, dom.create_endpoint(0, 9),
                     dom.create_endpoint(1, 9))
    h = ch.recv_i()
    assert h.cancel() is True
    assert h.cancel() is False
    ch.send("late")
    assert h.test() is False and h.state == states.OP_CANCELLED
    assert h.result is None


def test_broadcast_every_consumer_gets_every_item():
    bc = BroadcastChannel(3, capacity=8)
    for x in range(5):
        bc.publish(x)
    for c in range(3):
        got, ring = [], bc.consumer(c)
        while True:
            status, item = ring.read_item()
            if status != nbb.OK:
                break
            got.append(item)
        assert got == list(range(5)), (c, got)


# ---------------------------------------------------------------------------
# MESSAGE / PACKET / SCALAR channels over the lock-free rings and the
# locked baseline
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("lock_free", [True, False])
def test_mcapi_channel_roundtrip(lock_free):
    dom = Domain(lock_free=lock_free, queue_capacity=8)
    tx = dom.create_endpoint(node=1, port=0)
    for port, (ctype, payload) in enumerate([
            (ChannelType.MESSAGE, b"hello" * 5),
            (ChannelType.PACKET, bytes(24)),
            (ChannelType.SCALAR, -12345678901)], start=1):
        ch = dom.connect(ctype, tx, dom.create_endpoint(2, port))
        ch.send_blocking(payload)
        assert ch.recv_blocking() == payload


def test_scalar_widths():
    dom = Domain()
    ch = dom.connect(ChannelType.SCALAR, dom.create_endpoint(0, 1),
                     dom.create_endpoint(0, 2))
    for v in [0, 255, 2 ** 15 - 1, -2 ** 31, 2 ** 63 - 1]:
        ch.send_blocking(v)
        assert ch.recv_blocking() == v


@pytest.mark.parametrize("lock_free", [True, False])
def test_message_priority_fifo(lock_free):
    dom = Domain(lock_free=lock_free)
    msg = dom.connect(ChannelType.MESSAGE, dom.create_endpoint(0, 20),
                      dom.create_endpoint(1, 20))
    assert msg.msg_send("n1", priority=1) == nbb.OK
    assert msg.send("plain") == nbb.OK             # least urgent
    assert msg.msg_send("h1", priority=0) == nbb.OK
    assert msg.msg_send_i("h2", priority=0).completed
    assert msg.msg_send("n2", priority=1) == nbb.OK
    assert [msg.recv()[1] for _ in range(5)] == ["h1", "h2", "n1", "n2",
                                                 "plain"]
    assert msg.recv() == (nbb.BUFFER_EMPTY, None)


def test_message_priority_clamped_and_formats_enforced():
    dom = Domain(msg_priorities=2)
    msg = dom.connect(ChannelType.MESSAGE, dom.create_endpoint(0, 21),
                      dom.create_endpoint(1, 21))
    sca = dom.connect(ChannelType.SCALAR, dom.create_endpoint(0, 22),
                      dom.create_endpoint(1, 22))
    assert msg.msg_send("deep", priority=99) == nbb.OK   # clamps to 1
    assert msg.msg_send("top", priority=0) == nbb.OK
    assert msg.drain_burst() == ["top", "deep"]
    with pytest.raises(ValueError):
        msg.pkt_send_i(b"wrong format")
    with pytest.raises(ValueError):
        sca.msg_recv_i()
    with pytest.raises(ValueError):
        Domain(msg_priorities=0)
    with pytest.raises(ValueError, match="already exists"):
        dom.create_endpoint(0, 21)


def test_device_channel_perm():
    ch = DeviceChannel("stage")
    assert ch.perm(4) == [(0, 1), (1, 2), (2, 3), (3, 0)]
    assert ch.reverse().perm(4) == [(0, 3), (1, 0), (2, 1), (3, 2)]


# ---------------------------------------------------------------------------
# Bit set: host CAS allocator and the functional tensor form
# ---------------------------------------------------------------------------
def test_host_claim_release():
    b = bitset.HostBitset(4)
    assert sorted(b.try_claim(f"o{i}") for i in range(4)) == [0, 1, 2, 3]
    assert b.try_claim("x") is None
    b.release(2)
    assert b.try_claim("y") == 2
    with pytest.raises(KeyError):
        bitset.HostBitset(2).release(0)


def test_host_threaded_unique_claims():
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
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
    assert sorted(s for c in claims for s in c) == list(range(64))


def _sequence(nslots):
    """(op, slot): claim (slot ignored) or release(slot).  The set fills
    (past 32 slots into its second word) before the last claims, and a
    release in each word reopens a slot."""
    return ([("claim", 0)] * (nslots + 2)
            + [("release", 3), ("release", nslots - 2), ("claim", 0),
               ("release", 0)] + [("claim", 0)] * 4)


def _run(mod, as_slot, nslots):
    bits, got = mod.init(nslots), []
    for op, s in _sequence(nslots):
        if op == "claim":
            bits, slot = mod.claim_first_free(bits, nslots)
            got.append(int(slot))
        else:
            bits = mod.release(bits, as_slot(s))
            got.append(bool(mod.is_claimed(bits, as_slot(s))))
        got.append(int(mod.count(bits)))
    return got


@pytest.mark.parametrize("nslots", [5, 37, 40])
def test_functional_matches_reference(nslots):
    want = _run(jbitset, jnp.int32, nslots)
    got = _run(bitset, lambda s: torch.tensor(s), nslots)
    assert got == want
    assert -1 in got            # a claim on a full set fails, never blocks


def test_functional_claim_release_full():
    bits = bitset.init(5)
    slots = []
    for _ in range(5):
        bits, s = bitset.claim_first_free(bits, 5)
        slots.append(int(s))
    assert slots == [0, 1, 2, 3, 4]
    bits, s = bitset.claim_first_free(bits, 5)
    assert int(s) == -1
    bits = bitset.release(bits, 3)
    assert not bool(bitset.is_claimed(bits, 3))
    bits, s = bitset.claim_first_free(bits, 5)
    assert int(s) == 3 and int(bitset.count(bits)) == 5
    assert bits.dtype == torch.int64 and int(bits[0]) == 0b11111


@given(n=st.integers(1, 100))
@settings(max_examples=30, deadline=None)
def test_functional_count_matches(n):
    bits, jbits = bitset.init(n), jbitset.init(n)
    k = min(n, 7)
    for _ in range(k):
        bits, _ = bitset.claim_first_free(bits, n)
        jbits, _ = jbitset.claim_first_free(jbits, n)
    assert int(bitset.count(bits)) == k
    np.testing.assert_array_equal(bits.numpy(),
                                  np.asarray(jbits).astype(np.int64))
