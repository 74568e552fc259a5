"""Paged KV-cache pool with a lock-free refcounted page allocator.

The serving engine's KV memory is a fixed pool of fixed-size pages (the
vLLM idea): ``k``/``v`` are ``[n_pages, page_size, n_layers, kv_heads,
head_dim]`` tensors on the model's device — the same layout as the JAX
package — and they ARE the device-resident KV store of the
``slot_paged`` scheduler: decode attends straight through per-slot block
tables, admission/retire only edit int32 block-table rows and pages.

Page accounting uses the refcounted generalization of the paper's
lock-free **bit set** (:class:`RefCountArray`): claim-from-zero is a
single CAS, share/release are wait-free fetch-add / fetch-sub, and a
page re-enters the free set exactly when its count hits zero.  Admission
control stays non-blocking: over-subscription is rejected with an
explicit status (the NBB BUFFER_FULL discipline), never a blocked caller.

Prefix sharing rides on the counts: the :class:`PrefixCache` maps chained
chunk-aligned prompt hashes to page runs, admission increfs a hit's
pages instead of dispatching prefill, and a write into a page whose
count exceeds one is gated behind copy-on-write (``ensure_private``):
claim a fresh page, copy that one page in place on the device
(``index_copy_``), repoint the single block-table row, decref the shared
original.  CoW traffic is charged to ``kv_copy_bytes`` (mirrored in
``cow_copy_bytes``).

The host-offload preemption tier: ``swap_out_preempt`` parks a victim
sequence by gathering its PRIVATE written pages to host memory (one
indexed read, one ``.cpu()``) and releasing them — refcount>1 pages (live
prefix shares) are never moved or released, the victim keeps its
references — and leaves ``-1`` tombstones in its block-table row inside
a :class:`SwapImage`.  ``swap_in_preempt`` re-claims fresh pages
all-or-nothing and writes the saved bytes back in place
(``index_copy_``), so a resumed sequence reads back byte-identical
through the new physical page numbers.  Swap traffic is charged to
``kv_copy_bytes`` and itemized in ``swap_out_bytes``/``swap_in_bytes``,
so ``kv_copy_bytes == cow_copy_bytes + swap_in_bytes + swap_out_bytes``
under ``slot_paged``.  The retired ``swap_in``/``swap_out`` pair (dense
gather and scatter of a whole sequence; no scheduler calls it) charges
``kv_copy_bytes`` alone, as in the JAX package.
``snapshot_state``/``restore_state`` image and rebuild the whole pool for
crash recovery (``serve/snapshot.py``).  Host copies of page bytes are
numpy arrays; a bfloat16 pool's are the ``int16`` view of their bits
(:func:`to_host`), since numpy has no bfloat16 without ``ml_dtypes``.

The store holds one page more than the pool: page ``n_pages`` is the
write sink of masked rows (``models.layers.is_paged``) and is never
claimed, never in a block table, never read, swapped, imaged or
restored.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import faults as faults_mod
from repro_torch.core.refcount import RefCountArray

OK = 0
POOL_FULL = 1

# Host form of page bytes: numpy, with bfloat16 carried as its int16 bits.
_HOST_VIEW = {torch.bfloat16: torch.int16}


def to_host(t: torch.Tensor) -> np.ndarray:
    """A device tensor's bytes as a numpy array (one ``.cpu()``):
    bfloat16 as the ``int16`` view of its bits, other dtypes as
    themselves."""
    t = t.cpu()
    view = _HOST_VIEW.get(t.dtype)
    return (t.view(view) if view is not None else t).numpy()


def from_host(a: np.ndarray, dtype: torch.dtype,
              device: Union[str, torch.device]) -> torch.Tensor:
    """Inverse of :func:`to_host`: numpy bytes back to a ``dtype``
    tensor on ``device``."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype in _HOST_VIEW:
        t = t.view(dtype)
    return t.to(device=device, dtype=dtype)


@dataclasses.dataclass
class PageTable:
    """Host-side metadata for one sequence's pages.

    ``slot`` is the decode slot the sequence is bound to (None when
    unbound); ``n_reserved`` records the admission-time reservation so
    utilization stats can report how much of it a sequence consumed.
    """
    seq_id: int
    pages: List[int]
    n_tokens: int = 0
    slot: Optional[int] = None
    n_reserved: int = 0


@dataclasses.dataclass
class SwapImage:
    """Host-side parking record for one preempted sequence.  ``rows`` are
    the block-table rows whose private live pages were gathered into
    ``k``/``v`` (numpy in :func:`to_host` form, one entry per row, in row
    order); ``dead_rows`` were reserved-ahead (never-attended) pages
    released without copying; ``shared_rows`` are refcount>1 prefix
    pages that never moved — the sequence keeps its references and the
    block-table rows stay valid while parked."""
    seq_id: int
    rows: List[int]
    k: np.ndarray
    v: np.ndarray
    dead_rows: List[int]
    shared_rows: List[int]

    @property
    def nbytes(self) -> int:
        return int(self.k.nbytes) + int(self.v.nbytes)


class PagedKVPool:
    """One pool per (layer-stacked) KV tensor family.

    k/v: [n_pages, page_size, n_layers, kv_heads, head_dim] — layer
    innermost-batched so one page holds all layers for a token span and a
    sequence needs ceil(len/page_size) pages total (not per layer).
    ``store_k``/``store_v`` are the same tensors with the sink page
    appended; ``k``/``v`` are views of their first ``n_pages`` pages.
    """

    def __init__(self, n_pages: int, page_size: int, n_layers: int,
                 kv_heads: int, head_dim: int,
                 dtype: torch.dtype = torch.bfloat16,
                 device: Union[str, torch.device] = "cuda"):
        self.n_pages, self.page_size = n_pages, page_size
        self.n_layers, self.kv_heads, self.head_dim = (n_layers, kv_heads,
                                                       head_dim)
        shape = (n_pages + 1, page_size, n_layers, kv_heads, head_dim)
        self.store_k = torch.zeros(shape, dtype=dtype, device=device)
        self.store_v = torch.zeros(shape, dtype=dtype, device=device)
        self.k = self.store_k[:n_pages]
        self.v = self.store_v[:n_pages]
        self._alloc = RefCountArray(n_pages)
        self._tables: Dict[int, PageTable] = {}
        self._next_probe = 0
        # Honest KV-traffic counters: every byte moved to (re)establish
        # residency is charged here.  The paged scheduler's steady state
        # copies nothing, so this stays 0 until a copy-on-write fires
        # (``cow_copy_bytes`` isolates that share).
        self.kv_copy_bytes = 0
        self.cow_copy_bytes = 0
        self.swap_in_bytes = 0
        self.swap_out_bytes = 0
        self._peak_pages = 0
        self._shared_peak = 0
        # Pool-pressure escape hatch: the prefix cache registers its LRU
        # evictor here so resident-but-unreferenced prefixes yield their
        # pages before any claim fails.
        self._evict: Optional[Callable[[], bool]] = None
        # Fault-injection plan: armed by the engine; every probe below is
        # one ``is None`` check when disarmed.
        self.faults: Optional["faults_mod.FaultPlan"] = None
        # Pages implicated in a failed/poisoned write, pinned out of
        # circulation: quarantine holds one extra reference, so when the
        # owning sequence frees, the count lands at 1 — never 0 — and
        # claim-from-zero can never hand the page out again.
        self.quarantined: set = set()

    # -- allocation (lock-free) ------------------------------------------------
    def pages_needed(self, n_tokens: int) -> int:
        return max(1, math.ceil(n_tokens / self.page_size))

    def _claim_pages(self, n: int) -> Optional[List[int]]:
        """THE page-claim loop (every reservation path goes through it):
        claim ``n`` pages lock-free, all-or-nothing — on shortage the
        partial claim is rolled back and None returned, so concurrent
        admitters can't deadlock each other or strand half-claims."""
        if (n > 0 and self.faults is not None
                and self.faults.fire("pool.claim") is not None):
            return None                 # injected shortage: pre-claim, clean
        got: List[int] = []
        for _ in range(n):
            while True:
                # fresh token per claim: setdefault-CAS must not recognize
                # our own earlier claims as "won again"
                page = self._alloc.try_claim(owner=object(),
                                             start=self._next_probe)
                if page is not None:
                    break
                # Pool pressure: evict an unreferenced cached prefix and
                # retry before declaring shortage.  Eviction only drops
                # the cache's references, so a page still backing a live
                # sequence never leaves the pool here.
                if self._evict is None or not self._evict():
                    for p in got:  # roll back — nobody waits on us
                        self._alloc.release(p)
                    return None
            self._next_probe = (page + 1) % self.n_pages
            got.append(page)
        self._peak_pages = max(self._peak_pages, self.used_pages())
        return got

    def set_pressure_callback(self,
                              evict: Optional[Callable[[], bool]]) -> None:
        """Install the evict-one-prefix-under-pressure hook (returns True
        when it released something worth retrying the claim for)."""
        self._evict = evict

    @property
    def page_nbytes(self) -> int:
        """Device bytes one page occupies across both pool arrays."""
        return 2 * self.k[0].numel() * self.k.element_size()

    def reset_traffic(self) -> None:
        """Zero the copy/peak counters (benchmark pass boundaries)."""
        self.kv_copy_bytes = 0
        self.cow_copy_bytes = 0
        self.swap_in_bytes = 0
        self.swap_out_bytes = 0
        self._peak_pages = self.used_pages()
        self._shared_peak = self._alloc.shared_count()

    def try_admit(self, seq_id: int, n_tokens: int,
                  slot: Optional[int] = None) -> int:
        """Claim pages for a sequence.  OK or POOL_FULL (all-or-nothing).
        ``slot`` binds the reservation to a decode slot for per-slot
        accounting."""
        got = self._claim_pages(self.pages_needed(n_tokens))
        if got is None:
            return POOL_FULL
        self._tables[seq_id] = PageTable(seq_id, got, n_tokens, slot=slot,
                                         n_reserved=n_tokens)
        return OK

    # -- prefix sharing (refcounts + copy-on-write) -----------------------------
    def adopt_shared(self, seq_id: int, pages: List[int], n_tokens: int,
                     slot: Optional[int] = None) -> None:
        """Admit a sequence onto already-resident prefix pages: one incref
        per page and an int32 block-table row — no device work, no claim
        that can fail.  ``n_tokens`` is the prefix extent the pages cover
        (the sequence resumes prefill there)."""
        for p in pages:
            self._alloc.incref(p)
        self._tables[seq_id] = PageTable(seq_id, list(pages), n_tokens,
                                         slot=slot, n_reserved=n_tokens)
        self._note_sharing()
        self._peak_pages = max(self._peak_pages, self.used_pages())

    def incref_pages(self, pages: List[int]) -> None:
        """Take one reference per page (prefix-cache residency)."""
        for p in pages:
            self._alloc.incref(p)
        self._note_sharing()

    def decref_pages(self, pages: List[int]) -> None:
        """Drop one reference per page; pages whose count reaches zero
        re-enter the free set (prefix-cache eviction)."""
        for p in pages:
            self._alloc.decref(p)

    def refcount(self, page: int) -> int:
        return self._alloc.refcount(page)

    def _note_sharing(self) -> None:
        self._shared_peak = max(self._shared_peak,
                                self._alloc.shared_count())

    def ensure_private(self, seq_id: int, start_pos: int,
                       end_pos: int) -> int:
        """Copy-on-write gate: before a dispatch writes KV positions
        ``[start_pos, end_pos)`` of a sequence, repoint every page in
        that range that another holder can still read.  Per shared page:
        claim a fresh page, device-copy exactly that page, swap the one
        block-table row, decref the original (which stays resident for
        its other holders).  All-or-nothing like every claim path."""
        if end_pos <= start_pos:
            return OK
        t = self._tables[seq_id]
        ps = self.page_size
        first = start_pos // ps
        last = min((end_pos - 1) // ps, len(t.pages) - 1)
        rows = [i for i in range(first, last + 1)
                if self._alloc.refcount(t.pages[i]) > 1]
        if not rows:
            return OK
        if (self.faults is not None
                and self.faults.fire("pool.cow") is not None):
            return POOL_FULL            # injected: before any claim or copy
        fresh = self._claim_pages(len(rows))
        if fresh is None:
            return POOL_FULL
        self._copy_pages([t.pages[i] for i in rows], fresh)
        nbytes = len(rows) * self.page_nbytes
        self.kv_copy_bytes += nbytes
        self.cow_copy_bytes += nbytes
        for i, new_p in zip(rows, fresh):
            old = t.pages[i]
            t.pages[i] = new_p
            self._alloc.decref(old)
        return OK

    def _copy_pages(self, src: List[int], dst: List[int]) -> None:
        """Copy whole pages inside the pool tensors, in place (the JAX
        package's donated jitted copy)."""
        dev = self.store_k.device
        s = torch.tensor(src, dtype=torch.long, device=dev)
        d = torch.tensor(dst, dtype=torch.long, device=dev)
        self.store_k.index_copy_(0, d, self.store_k.index_select(0, s))
        self.store_v.index_copy_(0, d, self.store_v.index_select(0, s))

    def note_tokens(self, seq_id: int, n_tokens: int) -> None:
        """Record decode growth inside the existing reservation (no page
        traffic; keeps per-slot utilization stats truthful)."""
        self._tables[seq_id].n_tokens = n_tokens

    def extend_reservation(self, seq_id: int, n_tokens: int) -> int:
        """Grow a sequence's *reservation* to cover ``n_tokens`` without
        recording them as written (chunked admission: pages are claimed
        chunk by chunk as prompt positions materialize, then the decode
        budget is reserved with the final chunk).  All-or-nothing, so a
        mid-stream admission under memory pressure aborts cleanly."""
        t = self._tables[seq_id]
        need = self.pages_needed(n_tokens) - len(t.pages)
        if (need > 0 and self.faults is not None
                and self.faults.fire("pool.extend") is not None):
            return POOL_FULL            # injected: table untouched
        got = self._claim_pages(need)
        if got is None:
            return POOL_FULL
        t.pages.extend(got)
        t.n_reserved = max(t.n_reserved, n_tokens)
        return OK

    def grow(self, seq_id: int, new_n_tokens: int) -> int:
        """Extend a sequence (decode appends); claims pages as needed,
        all-or-nothing: POOL_FULL leaves the table as it was."""
        t = self._tables[seq_id]
        got = self._claim_pages(self.pages_needed(new_n_tokens)
                                - len(t.pages))
        if got is None:
            return POOL_FULL
        t.pages.extend(got)
        t.n_tokens = new_n_tokens
        return OK

    def free(self, seq_id: int) -> None:
        t = self._tables.pop(seq_id)
        for p in t.pages:
            if p >= 0:  # skip swap tombstones of a parked sequence
                self._alloc.release(p)

    def quarantine_range(self, seq_id: int, start_pos: int,
                         end_pos: int) -> List[int]:
        """Remove the pages backing positions ``[start_pos, end_pos)`` of
        a sequence from circulation after a failed/poisoned write.  Only
        PRIVATE pages (refcount == 1) are pinned: a shared page's bytes
        predate the failed write, so it is provably clean.  Pinning is one
        incref; the page stays accounted as used and, because claims only
        win on count zero, it can never back a future sequence.
        Idempotent per page.  Returns the pages quarantined by THIS
        call."""
        t = self._tables.get(seq_id)
        if t is None or end_pos <= start_pos:
            return []
        ps = self.page_size
        first = max(0, start_pos // ps)
        last = min((end_pos - 1) // ps, len(t.pages) - 1)
        got: List[int] = []
        for i in range(first, last + 1):
            p = t.pages[i]
            if (p >= 0 and p not in self.quarantined
                    and self._alloc.refcount(p) == 1):
                self._alloc.incref(p)
                self.quarantined.add(p)
                got.append(p)
        return got

    def free_pages(self) -> int:
        return self.n_pages - self._alloc.count()

    def used_pages(self) -> int:
        return self._alloc.count()

    def n_seqs(self) -> int:
        return len(self._tables)

    def table(self, seq_id: int) -> PageTable:
        return self._tables[seq_id]

    def stats(self) -> Dict[str, object]:
        """Snapshot for occupancy/utilization reporting: overall page use
        plus a per-slot breakdown {slot: (pages, tokens, reserved)}."""
        per_slot = {
            t.slot: (len(t.pages), t.n_tokens, t.n_reserved)
            for t in self._tables.values() if t.slot is not None
        }
        return {"n_pages": self.n_pages, "used": self.used_pages(),
                "free": self.free_pages(), "seqs": self.n_seqs(),
                "per_slot": per_slot,
                # Length-proportional residency: bytes of pool pages the
                # live sequences hold (each physical page once, however
                # many block-table rows point at it) and the high-water
                # mark, plus every byte spent COPYING KV.
                "kv_resident_bytes": self.used_pages() * self.page_nbytes,
                "kv_resident_bytes_peak": self._peak_pages * self.page_nbytes,
                "kv_copy_bytes": self.kv_copy_bytes,
                "cow_copy_bytes": self.cow_copy_bytes,
                "swap_in_bytes": self.swap_in_bytes,
                "swap_out_bytes": self.swap_out_bytes,
                "shared_pages": self._alloc.shared_count(),
                "shared_pages_peak": self._shared_peak,
                "quarantined": len(self.quarantined)}

    # -- device data movement (RETIRED: no scheduler calls these) -------------
    # Residency under ``slot_paged`` is established by writing block-table
    # rows, not by moving device memory.  The pair stays, as in the JAX
    # package, as the measured "what the block table deletes" baseline and
    # as the copy hook a host-offload tier would charge to
    # ``kv_copy_bytes``.
    def swap_in(self, seq_id: int, max_len: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Gather a sequence's pages -> contiguous [max_len, L, kv, hd]
        k/v, zero past its pages."""
        t = self._tables[seq_id]
        self.kv_copy_bytes += len(t.pages) * self.page_nbytes
        idx = torch.tensor(t.pages, dtype=torch.long,
                           device=self.store_k.device)
        tail = (self.n_layers, self.kv_heads, self.head_dim)
        k = self.store_k.index_select(0, idx).reshape((-1,) + tail)
        v = self.store_v.index_select(0, idx).reshape((-1,) + tail)
        pad = max_len - k.shape[0]
        if pad > 0:
            z = k.new_zeros((pad,) + tail)
            k, v = torch.cat([k, z]), torch.cat([v, z])
        return k[:max_len], v[:max_len]

    def swap_out(self, seq_id: int, k_seq: torch.Tensor,
                 v_seq: torch.Tensor, n_tokens: int) -> int:
        """Scatter contiguous [S, L, kv, hd] k/v back into the pool
        (in place, ``index_copy_`` into the store), after growing the
        sequence to ``n_tokens``."""
        status = self.grow(seq_id, n_tokens)
        if status != OK:
            return status
        t = self._tables[seq_id]
        ps = self.page_size
        n_pages = self.pages_needed(n_tokens)
        self.kv_copy_bytes += n_pages * self.page_nbytes
        pad = n_pages * ps - k_seq.shape[0]
        if pad > 0:
            z = k_seq.new_zeros((pad,) + tuple(k_seq.shape[1:]))
            k_seq, v_seq = torch.cat([k_seq, z]), torch.cat([v_seq, z])
        shape = (n_pages, ps, self.n_layers, self.kv_heads, self.head_dim)
        dev = self.store_k.device
        idx = torch.tensor(t.pages[:n_pages], dtype=torch.long, device=dev)
        self.store_k.index_copy_(0, idx, k_seq[:n_pages * ps].reshape(shape)
                                 .to(device=dev, dtype=self.k.dtype))
        self.store_v.index_copy_(0, idx, v_seq[:n_pages * ps].reshape(shape)
                                 .to(device=dev, dtype=self.v.dtype))
        return OK

    # -- device <-> host page movement -----------------------------------------
    def _gather_host(self, pages: List[int]):
        """The k and v bytes of ``pages`` in host form: one indexed read
        per store, ONE device->host fetch for both."""
        idx = torch.tensor(pages, dtype=torch.long,
                           device=self.store_k.device)
        kv = torch.stack((self.store_k.index_select(0, idx),
                          self.store_v.index_select(0, idx)))
        host = to_host(kv)
        return host[0], host[1]

    def _scatter_host(self, pages: List[int], k_host: np.ndarray,
                      v_host: np.ndarray) -> None:
        """Write host-form page bytes into ``pages``, in place
        (``index_copy_`` into the store; ``self.k``/``self.v`` stay the
        same views)."""
        dev = self.store_k.device
        d = torch.tensor(pages, dtype=torch.long, device=dev)
        self.store_k.index_copy_(0, d, from_host(k_host, self.k.dtype, dev))
        self.store_v.index_copy_(0, d, from_host(v_host, self.v.dtype, dev))

    # -- page-swap preemption (the overload tier) ------------------------------
    def swap_out_preempt(self, seq_id: int, n_live_tokens: int) -> SwapImage:
        """Park a sequence host-side, releasing its pool pages.

        Page disposition, by rule not position:
          * refcount > 1 (live prefix shares) — NEVER moved or
            released; the victim keeps its references and the rows stay
            valid, so a preempted prefix-cache hit leaves the shared
            pages resident and ``cow_copy_bytes`` untouched.
          * refcount == 1, row < live extent — gathered to host in one
            indexed read and one fetch, then released (``-1`` tombstone
            in the row).
          * refcount == 1, row >= live extent (reserved-ahead pages no
            token was ever written to) — released without copying;
            resume re-claims them blank, and positions past the live
            extent are never attended before being rewritten.

        Only the copied bytes are charged (``swap_out_bytes``, mirrored
        into ``kv_copy_bytes``)."""
        if (self.faults is not None
                and self.faults.fire("pool.swap_out") is not None):
            # Raised before ANY mutation: the victim's pages, table and
            # counters are untouched, so the engine treats this exactly
            # like "no preemptible victim".
            raise faults_mod.InjectedFault("pool.swap_out",
                                           self.faults.n_fired,
                                           retryable=True)
        t = self._tables[seq_id]
        live = 0 if n_live_tokens <= 0 else self.pages_needed(n_live_tokens)
        rows: List[int] = []
        dead_rows: List[int] = []
        shared_rows: List[int] = []
        for i, p in enumerate(t.pages):
            if p < 0:
                continue
            if self._alloc.refcount(p) > 1:
                shared_rows.append(i)
            elif i < live:
                rows.append(i)
            else:
                dead_rows.append(i)
        if rows:
            k_host, v_host = self._gather_host([t.pages[i] for i in rows])
        else:
            k_host = to_host(self.k[0:0])
            v_host = k_host
        for i in rows + dead_rows:
            self._alloc.release(t.pages[i])
            t.pages[i] = -1
        nbytes = len(rows) * self.page_nbytes
        self.swap_out_bytes += nbytes
        self.kv_copy_bytes += nbytes
        t.slot = None
        return SwapImage(seq_id, rows, k_host, v_host, dead_rows,
                         shared_rows)

    def swap_in_preempt(self, seq_id: int, image: SwapImage) -> int:
        """Re-establish a parked sequence's residency: claim fresh pages
        for every tombstoned row (all-or-nothing — POOL_FULL leaves the
        image and table untouched for a later retry), write the saved
        bytes back in place, and leave the shared rows alone (they never
        left).  The resumed sequence reads back byte-identical: pages
        moved wholesale, and the block-table indirection makes the new
        physical page numbers invisible."""
        if (self.faults is not None
                and self.faults.fire("pool.swap_in") is not None):
            return POOL_FULL            # injected: image stays parked
        t = self._tables[seq_id]
        need = len(image.rows) + len(image.dead_rows)
        got = self._claim_pages(need)
        if got is None:
            return POOL_FULL
        for i, p in zip(image.rows + image.dead_rows, got):
            t.pages[i] = p
        if image.rows:
            self._scatter_host(got[:len(image.rows)], image.k, image.v)
        nbytes = len(image.rows) * self.page_nbytes
        self.swap_in_bytes += nbytes
        self.kv_copy_bytes += nbytes
        self._peak_pages = max(self._peak_pages, self.used_pages())
        return OK

    # -- crash-recovery snapshots ----------------------------------------------
    def snapshot_state(self, extra_pages=()) -> Dict[str, object]:
        """Host-side image of the pool at a tick boundary: block tables,
        per-page refcounts, quarantine pins, traffic counters, and the
        bytes of every page that backs *written* positions — gathered
        once per distinct physical page in a single device fetch, so a
        page shared by N sequences (or pinned by a prefix-cache entry)
        costs one page of host memory, not N.  Reserved-ahead pages
        carry no bytes: nothing attended lives there, so restore
        re-claims them blank.  ``extra_pages`` lets the engine pin
        prefix-cache-resident pages whose owning sequences have already
        retired.  The sink page is never imaged."""
        refcounts = {p: self._alloc.refcount(p) for p in range(self.n_pages)
                     if self._alloc.refcount(p) > 0}
        tables = {sid: {"pages": list(t.pages), "n_tokens": t.n_tokens,
                        "slot": t.slot, "n_reserved": t.n_reserved}
                  for sid, t in self._tables.items()}
        need = {int(p) for p in extra_pages}
        for t in self._tables.values():
            if t.n_tokens > 0:
                live = min(self.pages_needed(t.n_tokens), len(t.pages))
                need.update(p for p in t.pages[:live] if p >= 0)
        idx = sorted(need)
        if idx:
            k_host, v_host = self._gather_host(idx)
        else:
            k_host = v_host = np.zeros((0,), np.int8)
        return {
            "n_pages": self.n_pages, "page_size": self.page_size,
            "refcounts": refcounts, "tables": tables,
            "quarantined": set(self.quarantined),
            "next_probe": self._next_probe,
            "counters": {
                "kv_copy_bytes": self.kv_copy_bytes,
                "cow_copy_bytes": self.cow_copy_bytes,
                "swap_in_bytes": self.swap_in_bytes,
                "swap_out_bytes": self.swap_out_bytes,
                "peak_pages": self._peak_pages,
                "shared_peak": self._shared_peak,
            },
            "data_pages": idx, "k": k_host, "v": v_host,
        }

    def reset(self) -> None:
        """Return the pool to its just-constructed state: the pool pages
        zeroed in place (stale bytes from a previous incarnation must not
        leak into restored sequences; the sink page is left alone), a
        fresh allocator, no tables, no quarantine, zero counters."""
        self.k.zero_()
        self.v.zero_()
        self._alloc = RefCountArray(self.n_pages)
        self._tables = {}
        self._next_probe = 0
        self.quarantined = set()
        self.kv_copy_bytes = 0
        self.cow_copy_bytes = 0
        self.swap_in_bytes = 0
        self.swap_out_bytes = 0
        self._peak_pages = 0
        self._shared_peak = 0

    def restore_state(self, state: Dict[str, object]) -> None:
        """Rebuild the pool from a :meth:`snapshot_state` image.  Every
        physical page id is re-claimed at its exact saved refcount via
        ``RefCountArray.claim_specific`` — block tables restore verbatim,
        so post-restore decode reads the same page numbers the snapshot
        recorded.  Saved page bytes are written back in place; traffic
        counters restore to their snapshotted values (the restore write
        itself is recovery traffic, not scheduler traffic, and is not
        charged)."""
        if (state["n_pages"] != self.n_pages
                or state["page_size"] != self.page_size):
            raise ValueError(
                f"pool shape mismatch: snapshot {state['n_pages']}p x "
                f"{state['page_size']}, pool {self.n_pages}p x "
                f"{self.page_size}")
        self.reset()
        for p, n in state["refcounts"].items():
            if not self._alloc.claim_specific(p):
                raise RuntimeError(f"page {p} not claimable on restore")
            for _ in range(n - 1):
                self._alloc.incref(p)
        self._tables = {
            sid: PageTable(sid, list(d["pages"]), d["n_tokens"],
                           slot=d["slot"], n_reserved=d["n_reserved"])
            for sid, d in state["tables"].items()}
        self.quarantined = set(state["quarantined"])
        self._next_probe = state["next_probe"]
        c = state["counters"]
        self.kv_copy_bytes = c["kv_copy_bytes"]
        self.cow_copy_bytes = c["cow_copy_bytes"]
        self.swap_in_bytes = c["swap_in_bytes"]
        self.swap_out_bytes = c["swap_out_bytes"]
        self._peak_pages = c["peak_pages"]
        self._shared_peak = c["shared_peak"]
        if state["data_pages"]:
            self._scatter_host(list(state["data_pages"]), state["k"],
                               state["v"])


@dataclasses.dataclass
class PrefixEntry:
    """One cached chunk-aligned prompt prefix: ``pages`` cover the first
    ``n_tokens`` positions of the (bucketed, left-padded) token stream
    whose chained chunk hash is ``key``.  The entry holds one reference
    per page, so the pages stay resident after every sequence that wrote
    or shared them has retired."""
    key: int
    n_tokens: int
    pages: List[int]
    tick: int = 0


class PrefixCache:
    """LRU map from chained chunk hashes to resident page runs.

    Hashes are chained (each chunk's hash folds in its predecessor's),
    so an entry for a shallow prefix of a cached deep prefix is its own
    key — a lookup walks candidate depths deepest-first and the first
    present entry wins, which is how "a prefix of a cached prefix also
    hits".  The cache registers its LRU evictor as the pool's pressure
    callback: page claims evict unreferenced prefixes before failing.
    """

    def __init__(self, pool: PagedKVPool):
        self.pool = pool
        self._entries: Dict[int, PrefixEntry] = {}
        self._clock = itertools.count()
        self.hits = 0
        self.misses = 0
        self.insertions = 0
        self.evictions = 0
        pool.set_pressure_callback(self.evict_lru)

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: int) -> bool:
        return key in self._entries

    def insert(self, key: int, n_tokens: int, pages: List[int]) -> bool:
        """Cache a prefix: one incref per page (the cache's own
        residency).  Idempotent per key — re-inserting bumps LRU only."""
        ent = self._entries.get(key)
        if ent is not None:
            ent.tick = next(self._clock)
            return False
        self.pool.incref_pages(pages)
        self._entries[key] = PrefixEntry(key, n_tokens, list(pages),
                                         next(self._clock))
        self.insertions += 1
        return True

    def lookup(self, keys: List[int]) -> Optional[PrefixEntry]:
        """Deepest-first probe: ``keys`` are chained hashes ordered
        deepest prefix first; the first cached one wins."""
        for key in keys:
            ent = self._entries.get(key)
            if ent is not None:
                ent.tick = next(self._clock)
                self.hits += 1
                return ent
        self.misses += 1
        return None

    def evict_key(self, key: int) -> bool:
        """Drop one entry's references (LRU eviction and the engine's
        abort rollback).  Pages no live sequence shares return to the
        free set; pages still backing sequences merely lose the cache's
        claim on them — never freed out from under a holder."""
        ent = self._entries.pop(key, None)
        if ent is None:
            return False
        self.pool.decref_pages(ent.pages)
        self.evictions += 1
        return True

    def evict_lru(self) -> bool:
        """Evict the least-recently-used prefix (pool-pressure hook)."""
        if not self._entries:
            return False
        return self.evict_key(
            min(self._entries, key=lambda k: self._entries[k].tick))

    def clear(self) -> None:
        while self.evict_lru():
            pass

    def resident_pages(self) -> set:
        """Physical pages the cache holds references on (each once)."""
        out: set = set()
        for ent in self._entries.values():
            out.update(ent.pages)
        return out

    def stats(self) -> Dict[str, int]:
        return {"entries": len(self._entries), "hits": self.hits,
                "misses": self.misses, "insertions": self.insertions,
                "evictions": self.evictions,
                "resident_pages": len(self.resident_pages())}
