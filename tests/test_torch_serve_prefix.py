"""Port counterpart of ``tests/test_serve_prefix.py``: the port's
prefix-sharing page pool (DESIGN.md §11): copy-on-write block tables
over lock-free refcounted pages, on the CPU, on the SMOKE model at
float32 with the reference's weights (``smoke_pair``).  A cached prefix
hit must admit with zero prefill dispatches and zero KV traffic;
divergence must copy exactly the diverged pages (and only for the
writer); and through all of it token sequences stay byte-identical to
the cold path.  The hit counts, the CoW bytes, the evictions and (at
one chunk size) the tokens are held to the reference engine's, computed
once per module (``ref_runs``); the pool-level cases run the same
script on the reference's pool and compare every count.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from _torch_parity import smoke_pair  # noqa: E402
from repro.serve.engine import ServeEngine as RefEngine  # noqa: E402
from repro.serve.kv_cache import PagedKVPool as RefPagedKVPool  # noqa: E402
from repro_torch.core import states  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.kv_cache import OK, POOL_FULL, PagedKVPool  # noqa: E402


def _engine(model, params, **kw):
    return ServeEngine(model, params, device="cpu", **kw)


@pytest.fixture(scope="module")
def pair():
    return smoke_pair()


@pytest.fixture(scope="module")
def engine_setup(pair):
    cfg, _, _, model, params = pair
    return cfg, model, params


def _serve(model, params, prompts, max_tokens, *, prefix_cache=True,
           drain_after_first=False, engine=_engine, **engine_kw):
    """Serve ``prompts`` in order on the port (or on ``engine``, the
    reference's class); returns (engine, token sequences in submission
    order).  ``drain_after_first`` completes the first request (the
    cache writer) before the rest are submitted as a burst."""
    kw = {"max_batch": 2, "max_len": 32, "pool_pages": 64, "page_size": 4}
    kw.update(engine_kw)
    eng = engine(model, params, n_clients=1, scheduler="slot_paged",
                 prefix_cache=prefix_cache, **kw)
    rids = []
    for j, p in enumerate(prompts):
        r = eng.submit(0, np.asarray(p, np.int32), max_tokens=max_tokens)
        assert r is not None
        rids.append(r.req_id)
        if drain_after_first and j == 0:
            while eng.stats["served"] < 1:
                eng.step()
    while eng.stats["served"] + eng.stats["rejected"] < len(prompts):
        eng.step()
    got = {}
    for _ in range(len(prompts)):
        r = eng.get_response(0, timeout_s=10)
        assert r, "response timed out"
        got[r.req_id] = list(map(int, r.tokens_out))
    return eng, [got[r] for r in rids]


def _shared_prompts(vocab):
    """Four prompts sharing a 12-token system prefix (bucket 16)."""
    shared = [(i * 5 + 2) % vocab for i in range(12)]
    return [shared + [(100 + 7 * j + i) % vocab for i in range(4)]
            for j in range(4)]


def _cow_prompts(vocab):
    """A, B sharing A's first 6 tokens, A again (bucket 8 each)."""
    base = [(i * 3 + 5) % vocab for i in range(6)]
    pa = base + [11, 12]
    return [pa, base + [201, 202], pa]


def _distinct_prompts(vocab):
    return [[(i * 13 + 31 * j + 1) % vocab for i in range(8)]
            for j in range(4)]


COW_KW = dict(chunk_tokens=2, max_len=16, pool_pages=32, page_size=4)
EVICT_KW = dict(max_batch=1, max_len=16, pool_pages=8, page_size=4,
                chunk_tokens=4)
STATS = ("prefix_hits", "prefill_tokens_saved", "prefill_chunks",
         "served", "rejected")


def _summary(eng, seqs):
    pool = eng.pool
    return (seqs, {k: eng.stats[k] for k in STATS}, pool.kv_copy_bytes,
            pool.cow_copy_bytes, pool.stats()["shared_pages_peak"],
            eng.prefix_cache.evictions)


@pytest.fixture(scope="module")
def ref_runs(pair):
    """The reference engine's runs on the same weights, computed once:
    the shared-prefix workload with the cache at chunk 4, the CoW
    workload and the eviction workload -> (tokens, counters, copy bytes,
    shared-page peak, evictions) each."""
    cfg, jm, jp, _, _ = pair
    v = cfg.vocab_size
    return {
        "hit": _summary(*_serve(jm, jp, _shared_prompts(v), 6,
                                chunk_tokens=4, drain_after_first=True,
                                engine=RefEngine)),
        "cow": _summary(*_serve(jm, jp, _cow_prompts(v), 4,
                                drain_after_first=True, engine=RefEngine,
                                **COW_KW)),
        "evict": _summary(*_serve(jm, jp, _distinct_prompts(v), 4,
                                  engine=RefEngine, **EVICT_KW)),
    }


def test_prefix_hit_equals_cold_across_chunk_sizes(engine_setup, ref_runs):
    """The acceptance property: four requests sharing a 12-token system
    prefix produce token sequences byte-identical with the cache on and
    off, at chunk_tokens 1, 4 and 8 — while the hits skip exactly the
    cached chunks (no dispatch, no KV copy: the shared extent here is
    page-aligned, so not even a CoW fires)."""
    cfg, model, params = engine_setup
    prompts = _shared_prompts(cfg.vocab_size)
    for chunk, e_hit in [(1, 12), (4, 12), (8, 8)]:
        e_off, s_off = _serve(model, params, prompts, 6,
                              prefix_cache=False, chunk_tokens=chunk,
                              drain_after_first=True)
        e_on, s_on = _serve(model, params, prompts, 6,
                            chunk_tokens=chunk, drain_after_first=True)
        assert s_on == s_off, f"chunk_tokens={chunk} diverged"
        assert e_on.stats["prefix_hits"] == 3
        assert e_on.stats["prefill_tokens_saved"] == 3 * e_hit
        # Chunk math: cold pays 4 whole prompts; hits resume at e_hit.
        assert e_off.stats["prefill_chunks"] == 4 * (16 // chunk)
        assert e_on.stats["prefill_chunks"] == (16 // chunk
                                                + 3 * (16 - e_hit) // chunk)
        # Page-aligned sharing is zero-copy: hits adopt rows, never copy.
        assert e_on.pool.kv_copy_bytes == 0
        assert e_on.pool.cow_copy_bytes == 0
        assert e_on.pool.stats()["shared_pages_peak"] > 0
        if chunk == 4:
            assert _summary(e_on, s_on) == ref_runs["hit"]


def test_cow_on_divergence_copies_one_page_each_way(engine_setup, ref_runs):
    """Divergence inside a shared page: B shares A's first 6 tokens
    (page_size=4 — the hit's trailing page is half A's, half B's), so
    B's first chunk must CoW exactly ONE page before writing.  A
    re-submission of A's exact prompt afterwards still hits and still
    matches A byte-for-byte — B's divergence never touched the shared
    physical pages."""
    cfg, model, params = engine_setup
    prompts = _cow_prompts(cfg.vocab_size)   # B diverges at position 6
    e_off, s_off = _serve(model, params, prompts, 4, prefix_cache=False,
                          drain_after_first=True, **COW_KW)
    eng, seqs = _serve(model, params, prompts, 4, drain_after_first=True,
                       **COW_KW)
    assert _summary(eng, seqs) == ref_runs["cow"]
    assert seqs == s_off                     # writer, divergent, re-hit
    assert seqs[2] == seqs[0], "sharer's tokens changed under B's CoW"
    assert eng.stats["prefix_hits"] == 2     # B and the A re-run hit E=6
    # Exactly one page copied per diverging writer (B rewrites positions
    # 6-7 of shared page 1; A2 rewrites the same positions of its own) —
    # and CoW is the ONLY KV traffic the paged path ever performs.
    assert eng.pool.cow_copy_bytes == 2 * eng.pool.page_nbytes
    assert eng.pool.kv_copy_bytes == eng.pool.cow_copy_bytes


def test_cancel_mid_decode_releases_refs_not_pages(engine_setup):
    """A hit sequence cancelled mid-decode gives back its page
    references; the cached prefix stays resident (never freed out from
    under the cache) and the entries the aborted sequence itself
    published roll back — the next identical request hits the intact
    prefix and reproduces the original tokens."""
    cfg, model, params = engine_setup
    eng = _engine(model, params, max_batch=2, max_len=32, n_clients=1,
                      pool_pages=64, page_size=4, scheduler="slot_paged",
                      chunk_tokens=4, k_max=2)
    prompt = np.asarray([(i * 9 + 4) % cfg.vocab_size for i in range(12)],
                        np.int32)            # bucket 16
    session = eng.connect(0)
    ha = session.submit_i(prompt, max_tokens=2)
    while eng.stats["served"] < 1:
        eng.tick()
    ra = ha.wait(timeout_s=10)
    resident = eng.prefix_cache.resident_pages()
    assert resident                          # E=4/8/12 prefixes cached
    hb = session.submit_i(prompt, max_tokens=12)
    while not any(s.request is not None and s.generated >= 2
                  for s in eng.slots):
        eng.tick()
    assert eng.stats["prefix_hits"] == 1
    assert hb.cancel() is True
    eng.tick()                               # abort sweep
    rb = hb.wait(timeout_s=10)
    assert rb.fsm.state == states.REQUEST_CANCELLED
    # B's references released, B's own published entries rolled back —
    # but the pages A's entries cover are exactly as resident as before.
    assert eng.prefix_cache.resident_pages() == resident
    assert eng.pool.used_pages() == len(resident)
    assert eng.pool.free_pages() == eng.pool.n_pages - len(resident)
    assert eng.pool.n_seqs() == 0
    hc = session.submit_i(prompt, max_tokens=2)
    while eng.stats["served"] < 2:
        eng.tick()
    rc = hc.wait(timeout_s=10)
    assert list(rc.tokens_out) == list(ra.tokens_out)
    assert eng.stats["prefix_hits"] == 2


def test_eviction_under_pressure_admits_instead_of_rejecting(engine_setup,
                                                            ref_runs):
    """Pool pressure evicts unreferenced cached prefixes before any
    claim fails: a pool that cannot hold the cache residue AND a new
    admission serves the new request anyway (LRU entries yield their
    pages) — and the tokens still match the cache-off run."""
    cfg, model, params = engine_setup
    prompts = _distinct_prompts(cfg.vocab_size)   # all misses
    e_off, s_off = _serve(model, params, prompts, 4, prefix_cache=False,
                          **EVICT_KW)
    eng, seqs = _serve(model, params, prompts, 4, **EVICT_KW)
    assert _summary(eng, seqs) == ref_runs["evict"]
    assert seqs == s_off
    assert eng.stats["served"] == 4
    assert eng.stats["rejected"] == 0, "pressure eviction failed to free"
    assert eng.prefix_cache.evictions > 0


# ---------------------------------------------------------------------------
# Pool-level: refcounted claim/rollback/accounting under sharing.
# ---------------------------------------------------------------------------
def _pool(n_pages=4, page_size=4, cls=None):
    if cls is not None:
        return cls(n_pages, page_size, n_layers=2, kv_heads=2, head_dim=4)
    return PagedKVPool(n_pages, page_size, n_layers=2, kv_heads=2,
                       head_dim=4, device="cpu")


def _pool_state(pool):
    """Every table's pages, every page's count, the byte counters."""
    return ({s: list(t.pages) for s, t in pool._tables.items()},
            [pool.refcount(p) for p in range(pool.n_pages)],
            pool.free_pages(), pool.cow_copy_bytes, pool.kv_copy_bytes)


def _as_in_reference(script, **kw):
    """``script(pool)`` on the port's pool and on the reference's with
    the same sizes: the final states must be equal."""
    port = _pool(**kw)
    script(port)
    ref = _pool(cls=RefPagedKVPool, **kw)
    script(ref)
    assert _pool_state(port) == _pool_state(ref)


def test_pool_resident_bytes_count_physical_pages_once():
    """kv_resident_bytes is physical: two sequences (plus the cache)
    sharing the same four pages cost four pages, not twelve."""
    pool = _pool(n_pages=8)
    assert pool.try_admit(0, 16) == OK       # 4 pages
    pages = list(pool.table(0).pages)
    pool.incref_pages(pages)                 # cache residency
    pool.adopt_shared(1, pages, 16)
    assert pool.used_pages() == 4
    assert pool.stats()["kv_resident_bytes"] == 4 * pool.page_nbytes
    assert pool.stats()["shared_pages"] == 4
    pool.free(0)
    pool.free(1)
    assert pool.used_pages() == 4            # cache still holds them
    pool.decref_pages(pages)
    assert pool.used_pages() == 0

    def ops(pool):
        pool.try_admit(0, 16)
        pages = list(pool.table(0).pages)
        pool.incref_pages(pages)
        pool.adopt_shared(1, pages, 16)
        pool.free(0)
    _as_in_reference(ops, n_pages=8)


def test_pool_partial_claim_rollback_never_frees_shared_pages():
    """All-or-nothing under sharing: an extend_reservation that cannot
    complete rolls back exactly the fresh pages it claimed — the shared
    pages the sequence adopted keep every reference, and retrying with a
    feasible size succeeds."""
    pool = _pool(n_pages=4)
    assert pool.try_admit(0, 8) == OK        # 2 pages
    shared = list(pool.table(0).pages)
    pool.incref_pages(shared)                # cache residency
    pool.adopt_shared(1, shared, 8)
    assert all(pool.refcount(p) == 3 for p in shared)
    # seq 1 wants 6 pages total; only 2 are free -> POOL_FULL, and the
    # partial claim (2 fresh pages) is returned exactly once.
    assert pool.extend_reservation(1, 24) == POOL_FULL
    assert all(pool.refcount(p) == 3 for p in shared)
    assert pool.free_pages() == 2
    assert pool.extend_reservation(1, 16) == OK
    assert pool.free_pages() == 0
    pool.free(1)                             # drops 1 ref on shared pages
    assert all(pool.refcount(p) == 2 for p in shared)
    pool.free(0)
    assert all(pool.refcount(p) == 1 for p in shared)
    pool.decref_pages(shared)
    assert pool.free_pages() == pool.n_pages

    def ops(pool):
        pool.try_admit(0, 8)
        shared = list(pool.table(0).pages)
        pool.incref_pages(shared)
        pool.adopt_shared(1, shared, 8)
        pool.extend_reservation(1, 24)           # refused, rolled back
        pool.extend_reservation(1, 16)
    _as_in_reference(ops, n_pages=4)


def test_pool_cow_exhaustion_fails_clean():
    """ensure_private with no free page: POOL_FULL, no refcount drift,
    no block-table mutation — the caller aborts the sequence whole."""
    pool = _pool(n_pages=4)
    assert pool.try_admit(0, 8) == OK
    shared = list(pool.table(0).pages)
    pool.incref_pages(shared)
    pool.adopt_shared(1, shared, 8)
    assert pool.try_admit(2, 8) == OK        # fills the pool
    assert pool.free_pages() == 0
    assert pool.ensure_private(1, 0, 8) == POOL_FULL
    assert list(pool.table(1).pages) == shared
    assert all(pool.refcount(p) == 3 for p in shared)
    assert pool.cow_copy_bytes == 0

    def ops(pool):
        pool.try_admit(0, 8)
        shared = list(pool.table(0).pages)
        pool.incref_pages(shared)
        pool.adopt_shared(1, shared, 8)
        pool.try_admit(2, 8)
        pool.ensure_private(1, 0, 8)             # refused: no free page
    _as_in_reference(ops, n_pages=4)


def test_pool_cow_copies_only_shared_rows():
    """ensure_private repoints exactly the rows another holder can read:
    private rows in the range are untouched, the old page stays resident
    for its other holders, and the traffic counters charge exactly the
    copied pages."""
    pool = _pool(n_pages=8)
    assert pool.try_admit(0, 12) == OK       # 3 pages
    pages = list(pool.table(0).pages)
    pool.incref_pages(pages[:2])             # cache holds first 2 only
    assert pool.ensure_private(0, 8, 12) == OK
    assert pool.cow_copy_bytes == 0          # row 2 was already private
    assert pool.ensure_private(0, 4, 12) == OK
    t = pool.table(0)
    assert t.pages[0] == pages[0]            # outside the write range
    assert t.pages[1] != pages[1]            # CoW'd
    assert t.pages[2] == pages[2]
    assert pool.refcount(pages[1]) == 1      # cache keeps the original
    assert pool.refcount(t.pages[1]) == 1
    assert pool.cow_copy_bytes == pool.page_nbytes
    assert pool.kv_copy_bytes == pool.page_nbytes

    def ops(pool):
        pool.try_admit(0, 12)
        pool.incref_pages(list(pool.table(0).pages)[:2])
        pool.ensure_private(0, 8, 12)
        pool.ensure_private(0, 4, 12)
    _as_in_reference(ops, n_pages=8)
