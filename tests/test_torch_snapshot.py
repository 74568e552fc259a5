"""Port counterpart of ``tests/test_snapshot.py``: the port's snapshot
layer (DESIGN.md §14): the torn-write-safe file protocol, the
write-ahead intake journal's torn-tail recovery, non-destructive ring
peeking, and FSM-cell pickling.

The intake journal's format is shared: a journal the port writes is
byte-for-byte the reference's for the same records, each package reads
the other's, and a torn tail leaves the same records in both.  A
snapshot file does not cross packages (its pages travel as int16 bits
in the port), so the file protocol is held on the port alone.
"""
import pickle

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core.nbb import HostNBB as RefHostNBB  # noqa: E402
from repro.serve.snapshot import IntakeJournal as RefIntakeJournal  # noqa: E402
from repro.serve.snapshot import peek_ring as ref_peek_ring  # noqa: E402
from repro_torch.core import states  # noqa: E402
from repro_torch.core.faults import FaultPlan, FaultRule  # noqa: E402
from repro_torch.core.host_queue import SpscQueue  # noqa: E402
from repro_torch.core.nbb import HostNBB  # noqa: E402
from repro_torch.serve.snapshot import (EngineSnapshot,  # noqa: E402
                                        IntakeJournal, SnapshotError,
                                        load_latest, peek_ring,
                                        read_snapshot, write_snapshot)


def _journal(cls, path, n=5):
    j = cls(path)
    for i in range(n):
        j.append({"req_id": i, "prompt": np.arange(i + 1)})
    j.close()
    return open(path, "rb").read()


def _snap(tag=0):
    return EngineSnapshot(
        config={"tag": tag}, journal_seq=0, next_req_id=7,
        pool={"n_pages": 4}, prefix_entries=[], slots=[],
        cur=np.arange(2, dtype=np.int32), pos=np.zeros(2, np.int32),
        parked=[], deferred=[], queued=[], undelivered={},
        stats={"served": tag})


class TestSnapshotFiles:
    def test_write_read_roundtrip(self, tmp_path):
        path = write_snapshot(_snap(3), str(tmp_path))
        got = read_snapshot(path)
        assert got.config == {"tag": 3} and got.next_req_id == 7
        assert np.array_equal(got.cur, np.arange(2, dtype=np.int32))

    def test_truncated_file_rejected(self, tmp_path):
        path = write_snapshot(_snap(), str(tmp_path))
        blob = open(path, "rb").read()
        for cut in (0, 3, len(blob) // 2, len(blob) - 1):
            with open(path, "wb") as f:
                f.write(blob[:cut])
            with pytest.raises(SnapshotError):
                read_snapshot(path)

    def test_bit_flip_rejected(self, tmp_path):
        path = write_snapshot(_snap(), str(tmp_path))
        blob = bytearray(open(path, "rb").read())
        blob[-1] ^= 0xFF
        with open(path, "wb") as f:
            f.write(bytes(blob))
        with pytest.raises(SnapshotError, match="checksum"):
            read_snapshot(path)

    def test_load_latest_skips_torn_newest(self, tmp_path):
        d = str(tmp_path)
        write_snapshot(_snap(1), d)
        good = write_snapshot(_snap(2), d)
        # A fault plan that tears the NEXT write at the final name —
        # exactly a crash mid-checkpoint.
        plan = FaultPlan([FaultRule("snapshot.write", nth=1)])
        assert write_snapshot(_snap(3), d, faults=plan) is None
        snap, path = load_latest(d)
        assert path == good and snap.config == {"tag": 2}

    def test_load_latest_empty_dir(self, tmp_path):
        assert load_latest(str(tmp_path / "nowhere")) == (None, None)

    def test_prunes_to_keep_newest(self, tmp_path):
        d = str(tmp_path)
        for i in range(12):
            write_snapshot(_snap(i), d, keep=8)
        snap, _ = load_latest(d)
        assert snap.config == {"tag": 11}
        import os
        kept = [n for n in os.listdir(d) if n.endswith(".ckpt")]
        assert len(kept) == 8


class TestIntakeJournal:
    def test_append_reopen_roundtrip(self, tmp_path):
        p = str(tmp_path / "j.wal")
        j = IntakeJournal(p)
        for i in range(5):
            assert j.append({"req_id": i,
                             "prompt": np.arange(i + 1)}) == i
        j.close()
        j2 = IntakeJournal(p)
        assert j2.seq == 5
        assert [r["req_id"] for r in j2.records] == list(range(5))
        assert np.array_equal(j2.records[3]["prompt"], np.arange(4))
        j2.close()
        # The same records give the reference's bytes, and each package
        # reads the other's journal.
        ref = str(tmp_path / "ref.wal")
        assert open(p, "rb").read() == _journal(RefIntakeJournal, ref)
        from_ref, to_ref = IntakeJournal(ref), RefIntakeJournal(p)
        assert [r["req_id"] for r in from_ref.records] == \
            [r["req_id"] for r in to_ref.records] == list(range(5))
        from_ref.close()
        to_ref.close()

    def test_torn_tail_truncated_then_appendable(self, tmp_path):
        p = str(tmp_path / "j.wal")
        j = IntakeJournal(p)
        j.append({"req_id": 0})
        j.append({"req_id": 1})
        j.close()
        with open(p, "ab") as f:        # a crash mid-append: garbage tail
            f.write(b"\x13\x00\x00\x00torn-record-garbag")
        j2 = IntakeJournal(p)
        assert j2.seq == 2              # tail dropped, good prefix kept
        j2.append({"req_id": 2})        # and the log is appendable again
        j2.close()
        j3 = IntakeJournal(p)
        assert [r["req_id"] for r in j3.records] == [0, 1, 2]
        j3.close()
        # The reference recovers the same torn file to the same records.
        ref = str(tmp_path / "ref.wal")
        _journal(RefIntakeJournal, ref, n=2)
        with open(ref, "ab") as f:
            f.write(b"\x13\x00\x00\x00torn-record-garbag")
        r2 = RefIntakeJournal(ref)
        assert r2.seq == 2
        r2.close()

    def test_empty_and_fresh_files(self, tmp_path):
        p = str(tmp_path / "sub" / "j.wal")
        j = IntakeJournal(p)            # creates the parent dir
        assert j.seq == 0 and j.records == []
        j.close()
        j2 = IntakeJournal(p)           # zero-length file reopens clean
        assert j2.seq == 0
        j2.close()


class TestPeekRing:
    def test_peek_is_nondestructive_and_ordered(self):
        q = SpscQueue(8)
        for i in range(5):
            q.insert_item(i)
        assert peek_ring(q) == [0, 1, 2, 3, 4]
        assert peek_ring(q) == [0, 1, 2, 3, 4]     # still all there
        assert q.read_item()[1] == 0               # consumer unaffected
        assert peek_ring(q) == [1, 2, 3, 4]

    def test_peek_wraps_and_sees_empty(self):
        q = HostNBB(4)
        assert peek_ring(q) == []
        for i in range(4):
            q.insert_item(i)
        for i in range(3):                          # force index wrap
            q.read_item()
            q.insert_item(10 + i)
        assert peek_ring(q) == [3, 10, 11, 12]
        r = RefHostNBB(4)
        for i in range(4):
            r.insert_item(i)
        for i in range(3):
            r.read_item()
            r.insert_item(10 + i)
        assert peek_ring(q) == ref_peek_ring(r)


class TestStateCellPickle:
    def test_roundtrip_preserves_table_identity(self):
        cell = states.request_cell("r")
        cell.transition(states.REQUEST_FREE, states.REQUEST_VALID)
        cell.transition(states.REQUEST_VALID, states.REQUEST_RECEIVED)
        c2 = pickle.loads(pickle.dumps(cell))
        assert c2.state == states.REQUEST_RECEIVED
        assert c2._table is states.REQUEST_TRANSITIONS
        # The journal compacts away: the restored cell starts from the
        # folded state, with full transition authority going forward.
        assert c2._journal == []
        assert c2.cas(states.REQUEST_RECEIVED, states.REQUEST_CANCELLED)
        assert c2.state == states.REQUEST_CANCELLED

    def test_buffer_cell_roundtrip(self):
        cell = states.buffer_cell("b")
        cell.transition(states.BUFFER_FREE, states.BUFFER_RESERVED)
        cell.transition(states.BUFFER_RESERVED, states.BUFFER_ALLOCATED)
        c2 = pickle.loads(pickle.dumps(cell))
        assert c2.state == states.BUFFER_ALLOCATED
        assert c2._table is states.BUFFER_TRANSITIONS

    def test_noncanonical_table_refuses_pickle(self):
        cell = states.StateCell({0: {1}}, 0, name="odd")
        with pytest.raises(TypeError):
            pickle.dumps(cell)
