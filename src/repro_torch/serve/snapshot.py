"""Crash-consistent engine snapshots + write-ahead intake journal.

Two complementary durability mechanisms:

- :class:`EngineSnapshot` — a full image of the serving engine's host
  state at a **tick boundary**: pool block tables + refcounts + the
  bytes of every written physical page (once per page, however many
  sequences share it), prefix-cache entries, every bound slot's
  Figure-4 FSM and decode cursors, parked sequences (their
  ``SwapImage`` host bytes travel along), deferred/queued requests, and
  the terminals still sitting undelivered in response rings.  Written
  with a tmp-file + blake2b-checksum + atomic-rename protocol, so a
  crash *during* snapshot write can never damage the last good
  snapshot — the loader checksum-rejects torn files and falls back.

- :class:`IntakeJournal` — an append-only WAL of BIND records.  A
  submission accepted after the last snapshot has no page/slot state
  worth imaging yet; its prompt + decode parameters are enough to
  replay it deterministically (greedy decode makes replay exact).  The
  journal is the cheap half of the division of labor: snapshots are
  periodic and heavy, journal appends are per-bind and tiny.

Page bytes travel as numpy arrays of the pool's dtype, except bfloat16,
which numpy cannot hold without ``ml_dtypes``: those pages are the raw
``int16`` view of their bits (``serve/kv_cache.py`` ``to_host`` /
``from_host``), as the training checkpoints store bf16 leaves.  A
snapshot therefore unpickles anywhere numpy does; it is an image of the
port's engine and does not restore into the JAX package's, or back.

Fault sites (``core.faults``): ``snapshot.write`` tears the file
mid-write (simulating death during checkpoint), ``snapshot.restore``
aborts a restore before any mutation, ``journal.append`` loses one WAL
record.  All three are probed by the callers in ``serve/engine.py``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import pickle
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

MAGIC = b"RSNAP1\n"
_HDR = struct.Struct("<Q16s")        # payload length + blake2b-128 digest
_JHDR = struct.Struct("<I8s")        # record length + blake2b-64 digest


class SnapshotError(RuntimeError):
    """A snapshot could not be written, read, or restored."""


def _digest(payload: bytes, size: int) -> bytes:
    return hashlib.blake2b(payload, digest_size=size).digest()


@dataclasses.dataclass
class SlotImage:
    """One bound decode slot, exactly as the scheduler left it at the
    tick boundary: the Figure-4 buffer FSM cell (``fsm``), the request
    (its own Figure-3 FSM rides inside), decode cursors (``pos`` /
    ``cur_token``), the emitted-token high-water mark (``generated`` —
    every position below it has been streamed at least once), the
    output buffer, and the chunked-prefill extent (``prefill_pos`` plus
    the staged padded prompt)."""
    index: int
    fsm: object
    request: object
    cur_token: int
    pos: int
    generated: int
    outs: Optional[np.ndarray]
    prompt: Optional[np.ndarray]
    prefill_pos: int
    next_tok: Optional[int]
    chunk_hashes: List[int]
    pending_prefix: List[Tuple]
    created_prefixes: List[Tuple]
    fresh_resume: bool


@dataclasses.dataclass
class EngineSnapshot:
    """Everything ``ServeEngine.restore`` needs, host-side and
    self-contained.  ``config`` is the engine fingerprint asserted at
    restore (a snapshot only restores onto an identically-shaped
    engine); ``journal_seq`` is the WAL high-water mark — records at or
    beyond it replay as fresh submissions."""
    config: Dict[str, object]
    journal_seq: int
    next_req_id: int
    pool: Dict[str, object]
    prefix_entries: List[Tuple[int, int, List[int]]]   # LRU order
    slots: List[SlotImage]
    cur: np.ndarray
    pos: np.ndarray
    parked: List[object]
    deferred: List[Tuple[object, List[int]]]
    queued: List[object]                    # intake-resident requests
    undelivered: Dict[int, List[object]]    # client -> terminals in-ring
    stats: Dict[str, object]


# -- ring peeking ------------------------------------------------------------

def peek_ring(ring) -> List[object]:
    """Non-destructively read every committed item in a HostNBB ring in
    consumer order.  Snapshot capture must not consume: the running
    engine (and its clients) still own these entries; the snapshot just
    records what a crash at this boundary would strand in flight."""
    ring = getattr(ring, "inner", ring)     # unwrap FaultyTransport
    uc, ac, n = ring._uc, ring._ac, ring._n
    avail = (uc // 2) - (ac // 2)
    start = (ac // 2) % n
    return [ring._slots[(start + j) % n] for j in range(avail)]


# -- snapshot files ----------------------------------------------------------

def _snap_paths(dirpath: str) -> List[str]:
    try:
        names = sorted(n for n in os.listdir(dirpath)
                       if n.startswith("snap-") and n.endswith(".ckpt"))
    except FileNotFoundError:
        return []
    return [os.path.join(dirpath, n) for n in names]


def write_snapshot(snap: EngineSnapshot, dirpath: str, *,
                   faults=None, keep: int = 8) -> Optional[str]:
    """Serialize + write with the torn-write-safe protocol: full blob to
    a ``.tmp`` sibling, fsync, then atomic rename.  The ``snapshot.write``
    fault site simulates the process dying mid-write — half the blob
    lands at the FINAL name, which is exactly the corruption the loader
    must survive (checksum reject + fall back to the previous good
    file).  Returns the path on success, None on an injected tear."""
    os.makedirs(dirpath, exist_ok=True)
    payload = pickle.dumps(snap, protocol=pickle.HIGHEST_PROTOCOL)
    blob = MAGIC + _HDR.pack(len(payload), _digest(payload, 16)) + payload
    existing = _snap_paths(dirpath)
    seq = 0
    if existing:
        seq = 1 + max(int(os.path.basename(p)[5:-5]) for p in existing)
    final = os.path.join(dirpath, f"snap-{seq:08d}.ckpt")
    if faults is not None and faults.fire("snapshot.write") is not None:
        with open(final, "wb") as f:        # torn: no tmp, no rename
            f.write(blob[:max(1, len(blob) // 2)])
        return None
    tmp = final + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)
    for p in _snap_paths(dirpath)[:-keep]:
        with open(p, "rb"):                 # touch before unlink: be sure
            pass                            # it's ours, not a foreign file
        os.unlink(p)
    return final


def read_snapshot(path: str) -> EngineSnapshot:
    """Read + validate one snapshot file; :class:`SnapshotError` on any
    torn/truncated/corrupt content."""
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError as exc:
        raise SnapshotError(f"unreadable snapshot {path}: {exc}")
    if not blob.startswith(MAGIC) or len(blob) < len(MAGIC) + _HDR.size:
        raise SnapshotError(f"torn snapshot {path}: bad header")
    length, digest = _HDR.unpack_from(blob, len(MAGIC))
    payload = blob[len(MAGIC) + _HDR.size:]
    if len(payload) != length or _digest(payload, 16) != digest:
        raise SnapshotError(f"torn snapshot {path}: checksum mismatch")
    try:
        snap = pickle.loads(payload)
    except Exception as exc:
        raise SnapshotError(f"undecodable snapshot {path}: {exc}")
    if not isinstance(snap, EngineSnapshot):
        raise SnapshotError(f"not an EngineSnapshot: {path}")
    return snap


def load_latest(dirpath: str) -> Tuple[Optional[EngineSnapshot],
                                       Optional[str]]:
    """Newest *valid* snapshot in ``dirpath`` — torn files (from a crash
    or an injected ``snapshot.write`` fault) are skipped, falling back
    to the previous good one.  ``(None, None)`` when nothing usable."""
    for path in reversed(_snap_paths(dirpath)):
        try:
            return read_snapshot(path), path
        except SnapshotError:
            continue
    return None, None


# -- the write-ahead intake journal ------------------------------------------

class IntakeJournal:
    """Append-only BIND log with per-record checksum framing.

    Torn tails (a crash mid-append) are tolerated: on open, the file is
    scanned record-by-record and truncated back to the last good frame,
    so the next append never buries valid records behind garbage.
    ``records`` holds every surviving record in append order;
    ``seq`` (== len(records)) is the high-water mark snapshots capture.
    """

    def __init__(self, path: str):
        self.path = path
        self.records: List[Dict] = []
        good = 0
        if os.path.exists(path):
            with open(path, "rb") as f:
                blob = f.read()
            off = 0
            while off + _JHDR.size <= len(blob):
                length, digest = _JHDR.unpack_from(blob, off)
                body = blob[off + _JHDR.size: off + _JHDR.size + length]
                if len(body) != length or _digest(body, 8) != digest:
                    break
                try:
                    self.records.append(pickle.loads(body))
                except Exception:
                    break
                off += _JHDR.size + length
                good = off
            if good != len(blob):
                with open(path, "r+b") as f:   # drop the torn tail
                    f.truncate(good)
        else:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.seq = len(self.records)
        self._f = open(path, "ab")

    def append(self, record: Dict) -> int:
        """Durably append one record; returns its sequence number."""
        body = pickle.dumps(record, protocol=pickle.HIGHEST_PROTOCOL)
        self._f.write(_JHDR.pack(len(body), _digest(body, 8)) + body)
        self._f.flush()
        os.fsync(self._f.fileno())
        self.records.append(record)
        seq = self.seq
        self.seq += 1
        return seq

    def close(self) -> None:
        try:
            self._f.close()
        except OSError:
            pass
