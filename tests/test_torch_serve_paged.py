"""Port counterpart of ``tests/test_serve_paged.py``: paged KV
residency (``scheduler="slot_paged"``, DESIGN.md §10) in the port, on
the CPU, on the SMOKE model at float32 with the reference's weights
(``smoke_pair``).  Token sequences must be byte-identical to the dense
schedulers; residency must move zero KV bytes and scale with actual
tokens, not max_len.  At one chunk size per equivalence the tokens are
also held to the reference engine's, computed once per module
(``ref_tokens``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import smoke_pair  # noqa: E402
from repro.serve.engine import ServeEngine as RefEngine  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import states  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402


def _engine(model, params, **kw):
    return ServeEngine(model, params, device="cpu", **kw)


@pytest.fixture(scope="module")
def pair():
    return smoke_pair()


@pytest.fixture(scope="module")
def engine_setup(pair):
    cfg, _, _, model, params = pair
    return cfg, model, params


def _run_workload(model, params, scheduler, lengths, vocab, eos_id=-1,
                  engine=_engine, **engine_kw):
    """Serve a fixed workload on the port (or on ``engine``, the
    reference's class); returns (engine, per-request sequences in
    submission order)."""
    kw = {"max_batch": 2, "max_len": 64, "pool_pages": 256}
    kw.update(engine_kw)
    eng = engine(model, params, n_clients=1, scheduler=scheduler, **kw)
    rids = []
    for i, n in enumerate(lengths):
        r = eng.submit(0, (np.arange(4) + i) % vocab, max_tokens=n,
                       eos_id=eos_id)
        assert r is not None
        rids.append(r.req_id)
    while eng.stats["served"] + eng.stats["rejected"] < len(lengths):
        eng.step()
    got = {}
    for _ in range(len(lengths)):
        r = eng.get_response(0, timeout_s=10)
        assert r, "response timed out"
        got[r.req_id] = list(map(int, r.tokens_out))
    return eng, [got[r] for r in rids]


MIXED = [12, 2, 7, 2, 1, 9, 24, 3]      # mixed, forces adaptive K
BOUNDARY = dict(page_size=4, chunk_tokens=8, k_max=8)


@pytest.fixture(scope="module")
def ref_tokens(pair):
    """The reference engine's ``slot_paged`` tokens on the same weights,
    computed once: the mixed workload at chunk 4, the page-boundary
    workload, and the EOS workload (its EOS the reference's own first
    token)."""
    cfg, jm, jp, _, _ = pair
    v = cfg.vocab_size

    def run(lengths, **kw):
        return _run_workload(jm, jp, "slot_paged", lengths, v,
                             engine=RefEngine, **kw)[1]

    eos = run([6], chunk_tokens=4)[0][0]
    return {"mixed": run(MIXED, chunk_tokens=4),
            "boundary": run([14, 3, 11], **BOUNDARY),
            "eos": eos, "eos_run": run([6, 17], eos_id=eos, chunk_tokens=4)}


def test_paged_equals_fused_across_chunk_sizes(engine_setup, ref_tokens):
    """The acceptance property: for chunk sizes 1, 4 and a whole
    bucketed prompt, slot_paged emits token sequences byte-identical to
    slot_fused — block-table indirection changes where KV lives, never
    the tokens — while performing ZERO KV copy traffic: no gather/
    scatter dispatch, no cache-copy dispatch, no dense batch cache."""
    cfg, model, params = engine_setup
    lengths = MIXED
    e_fused, s_fused = _run_workload(model, params, "slot_fused", lengths,
                                     cfg.vocab_size)
    assert e_fused.pool.kv_copy_bytes > 0     # the copies paged deletes
    for chunk in (1, 4, 8):                   # prompts bucket to 8
        e_p, s_p = _run_workload(model, params, "slot_paged", lengths,
                                 cfg.vocab_size, chunk_tokens=chunk)
        assert s_p == s_fused, f"chunk_tokens={chunk} diverged"
        if chunk == 4:
            assert s_p == ref_tokens["mixed"]
        # Zero-copy residency (the acceptance criterion): after chunked
        # admission wrote KV in place, NO bytes were ever copied to
        # establish or move residency.
        assert e_p.pool.kv_copy_bytes == 0
        assert e_p.stats["cache_copy_dispatches"] == 0
        assert e_p.stats["admission_stall_steps"] == 0
        assert e_p._caches is None, "dense batch cache was allocated"
        assert e_p.pool.free_pages() == e_p.pool.n_pages


def test_paged_page_boundary_crossing_mid_block(engine_setup, ref_tokens):
    """A fused K-step block whose decode positions cross page boundaries
    mid-block (page_size=4, K up to 8) scatters each token into the
    right (page, offset) — sequences stay identical to the scalar slot
    path and pages are accounted per boundary."""
    cfg, model, params = engine_setup
    lengths = [14, 3, 11]                     # crosses 3+ boundaries
    _, s_slot = _run_workload(model, params, "slot", lengths,
                              cfg.vocab_size, page_size=4)
    e_p, s_p = _run_workload(model, params, "slot_paged", lengths,
                             cfg.vocab_size, **BOUNDARY)
    assert s_p == s_slot
    assert s_p == ref_tokens["boundary"]
    # Cached prefixes stay resident after their writers retire (that is
    # the point — the next request hits them); only the cache holds
    # pages now, and clearing it drains the pool completely.
    e_p.prefix_cache.clear()
    assert e_p.pool.free_pages() == e_p.pool.n_pages
    assert e_p.pool.kv_copy_bytes == 0


def test_paged_eos_masking_matches_scalar(engine_setup, ref_tokens):
    """A row that joins the decode block in the same dispatch as its
    final chunk stops exactly at EOS on the paged backend too."""
    cfg, model, params = engine_setup
    _, seqs = _run_workload(model, params, "slot_paged", [6],
                            cfg.vocab_size, chunk_tokens=4)
    eos = seqs[0][0]
    assert eos == ref_tokens["eos"]
    _, s_slot = _run_workload(model, params, "slot", [6, 17],
                              cfg.vocab_size, eos_id=eos)
    _, s_p = _run_workload(model, params, "slot_paged", [6, 17],
                           cfg.vocab_size, eos_id=eos, chunk_tokens=4)
    assert s_p == s_slot
    assert s_p == ref_tokens["eos_run"]


def test_paged_pool_exhaustion_mid_stream_rejects(engine_setup):
    """A prompt that outgrows the pool mid-stream aborts whole: pages
    roll back, the RESERVED slot takes the direct RESERVED->FREE edge,
    and the batcher keeps serving."""
    cfg, model, params = engine_setup
    eng = _engine(model, params, max_batch=2, max_len=128, n_clients=1,
                      pool_pages=4, page_size=4,   # 16 tokens of KV total
                      scheduler="slot_paged", chunk_tokens=4)
    eng.submit(0, np.arange(30) % cfg.vocab_size, max_tokens=8)  # bucket 32
    eng.step()
    resp = eng.get_response(0, timeout_s=10)
    assert resp.fsm.state == states.REQUEST_CANCELLED
    assert eng.stats["rejected"] == 1
    assert eng.pool.free_pages() == eng.pool.n_pages
    for slot in eng.slots:
        assert slot.fsm.state == states.BUFFER_FREE
    # the batcher is not wedged
    eng.submit(0, np.arange(4) % cfg.vocab_size, max_tokens=2)
    eng.step()
    assert eng.get_response(0, 10).fsm.state == states.REQUEST_COMPLETED


def test_paged_cancel_mid_stream_releases_reserved_slot(engine_setup):
    """cancel() while a prompt streams into pages: RESERVED->FREE, all
    pages back, no KV bytes ever moved."""
    cfg, model, params = engine_setup
    eng = _engine(model, params, max_batch=2, max_len=128, n_clients=1,
                      pool_pages=256, scheduler="slot_paged",
                      chunk_tokens=4)
    session = eng.connect(0)
    h1 = session.submit_i(np.arange(4) % cfg.vocab_size, max_tokens=20)
    for _ in range(3):
        eng.tick()
    h2 = session.submit_i(np.arange(40) % cfg.vocab_size, max_tokens=8)
    eng.tick()
    eng.tick()
    mid = [s for s in eng.slots
           if s.request is not None and s.generated == 0]
    assert mid and 0 < mid[0].prefill_pos < len(mid[0].prompt)
    assert h2.cancel() is True
    eng.tick()                          # abort sweep releases RESERVED slot
    r2 = h2.wait(timeout_s=10)
    assert r2.fsm.state == states.REQUEST_CANCELLED
    assert len(r2.tokens_out) == 0
    while eng.stats["served"] < 1:
        eng.tick()
    r1 = h1.wait(timeout_s=10)
    assert len(r1.tokens_out) == 20
    assert eng.pool.free_pages() == eng.pool.n_pages
    assert eng.pool.kv_copy_bytes == 0
    for slot in eng.slots:
        assert slot.fsm.state == states.BUFFER_FREE


def test_paged_resident_memory_is_length_proportional(engine_setup):
    """The memory acceptance criterion: at max_batch=8 with a mixed-
    length workload, peak paged residency is at most half the dense
    batch-cache footprint — per-slot memory is O(actual tokens), not
    O(max_len)."""
    cfg, model, params = engine_setup
    eng = _engine(model, params, max_batch=8, max_len=128, n_clients=1,
                      pool_pages=64, page_size=16, intake_depth=32,
                      scheduler="slot_paged", chunk_tokens=16)
    # Mixed lengths: prompts 4..20 (buckets 8..32), budgets 2..24.
    work = [(4, 2), (12, 24), (4, 8), (20, 4), (7, 16), (4, 2), (9, 12),
            (16, 6)]
    for i, (plen, mt) in enumerate(work):
        assert eng.submit(0, (np.arange(plen) + i) % cfg.vocab_size,
                          max_tokens=mt) is not None
    # The first tick's admission sweep binds every slot at once (worst
    # concurrency — captured by the peak counter); short requests may
    # already retire inside it, so sample live residency right after.
    eng.tick()
    mid_resident = eng.pool.stats()["kv_resident_bytes"]
    assert mid_resident > 0
    while eng.stats["served"] < len(work):
        eng.step()
    for _ in range(len(work)):
        assert eng.get_response(0, timeout_s=10)
    # Retired writers leave their shareable prefixes resident in the
    # cache on purpose; drop them so the zero-residency drain assert
    # below measures live sequences only.
    eng.prefix_cache.clear()
    stats = eng.pool.stats()
    dense = eng.dense_cache_bytes()
    assert stats["kv_resident_bytes_peak"] <= 0.5 * dense, (stats, dense)
    assert mid_resident <= 0.5 * dense
    assert stats["kv_resident_bytes"] == 0          # all pages returned
    assert stats["kv_copy_bytes"] == 0
    assert eng._caches is None


def test_paged_streaming_delivers_every_position_once(engine_setup):
    """The streaming surface rides the paged scheduler unchanged: every
    position exactly once, in order, with the terminal recovering any
    backpressure drops."""
    cfg, model, params = engine_setup
    eng = _engine(model, params, max_batch=2, max_len=64, n_clients=1,
                      pool_pages=256, scheduler="slot_paged")
    session = eng.connect(0)
    h = session.submit_i(np.arange(5) % cfg.vocab_size, max_tokens=12)
    got = {}
    it = h.tokens(timeout_s=10)
    while True:
        eng.step()
        if h.test():
            break
    for pos, tok in it:
        assert pos not in got
        got[pos] = tok
    assert sorted(got) == list(range(12))
    assert list(h.response.tokens_out) == [got[p] for p in range(12)]


def test_paged_rejects_unpageable_arch(engine_setup):
    """Recurrent state cannot be paged: the constructor refuses with a
    clear error instead of corrupting pages."""
    cfg = get_smoke_config("zamba2-2.7b")
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="slot_paged"):
        _engine(model, params, scheduler="slot_paged")
