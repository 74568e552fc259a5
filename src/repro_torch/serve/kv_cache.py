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
original.  CoW traffic is the only KV copying the paged scheduler ever
performs and is charged to ``kv_copy_bytes`` (mirrored in
``cow_copy_bytes``).

The store holds one page more than the pool: page ``n_pages`` is the
write sink of masked rows (``models.layers.is_paged``) and is never
claimed, never in a block table, never read.  Page-swap preemption and
crash-recovery snapshots wait for later slices.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Callable, Dict, List, Optional, Union

import torch

from repro_torch.core import faults as faults_mod
from repro_torch.core.refcount import RefCountArray

OK = 0
POOL_FULL = 1


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
        self._peak_pages = 0
        self._shared_peak = 0
        # Pool-pressure escape hatch: the prefix cache registers its LRU
        # evictor here so resident-but-unreferenced prefixes yield their
        # pages before any claim fails.
        self._evict: Optional[Callable[[], bool]] = None
        # Fault-injection plan: no plan is armed in this port yet; every
        # probe below is one ``is None`` check.
        self.faults: Optional["faults_mod.FaultPlan"] = None

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

    def free(self, seq_id: int) -> None:
        t = self._tables.pop(seq_id)
        for p in t.pages:
            self._alloc.release(p)

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
                "shared_pages": self._alloc.shared_count(),
                "shared_pages_peak": self._shared_peak}


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
