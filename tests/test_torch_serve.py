"""The port's ``slot_paged`` ServeEngine (device="cpu") against the JAX
package's on the same workloads and converted weights: per-request token
sequences must be identical and the deterministic counters equal
(``decode_steps``, ``host_syncs``, ``prefill_chunks``, ``prefix_hits``,
``prefill_tokens_saved``, ``kv_copy_bytes``).  Also: streamed tokens are
delivered exactly once, and a cancel mid-stream returns the pool to its
baseline."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from _torch_parity import smoke_pair  # noqa: E402
from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.core import states  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

COUNTERS = ("decode_steps", "host_syncs", "prefill_chunks", "prefix_hits",
            "prefill_tokens_saved")


@pytest.fixture(scope="module")
def pair():
    return smoke_pair()


def _serve(engine, prompts, max_tokens, drain_after_first=False):
    """Submit in order (optionally finishing the first request before the
    rest arrive as a burst); returns token sequences in submission
    order."""
    rids = []
    for j, p in enumerate(prompts):
        r = engine.submit(0, np.asarray(p, np.int32),
                          max_tokens=max_tokens[j])
        assert r is not None
        rids.append(r.req_id)
        if drain_after_first and j == 0:
            while engine.stats["served"] < 1:
                engine.step()
    while (engine.stats["served"] + engine.stats["rejected"]
           < len(prompts)):
        engine.step()
    got = {}
    for _ in prompts:
        r = engine.get_response(0, timeout_s=10)
        assert r, "response timed out"
        got[r.req_id] = list(map(int, r.tokens_out))
    return [got[r] for r in rids]


def _both(pair, prompts, max_tokens, drain_after_first=False, **kw):
    _, jm, jp, tm, tp = pair
    je = JaxEngine(jm, jp, n_clients=1, scheduler="slot_paged", **kw)
    te = ServeEngine(tm, tp, n_clients=1, device="cpu", **kw)
    js = _serve(je, prompts, max_tokens, drain_after_first)
    ts = _serve(te, prompts, max_tokens, drain_after_first)
    return (je, js), (te, ts)


def _assert_same(jres, tres):
    (je, js), (te, ts) = jres, tres
    assert ts == js
    for key in COUNTERS:
        assert te.stats[key] == je.stats[key], key
    assert te.pool.kv_copy_bytes == je.pool.kv_copy_bytes


@pytest.mark.parametrize("chunk", [1, 4, 8])
def test_mixed_workload_matches_reference(pair, chunk):
    """tests/test_serve_paged.py's workload: mixed budgets force adaptive
    K, joins and retirements inside blocks."""
    lengths = [12, 2, 7, 2, 1, 9, 24, 3]
    vocab = pair[0].vocab_size
    prompts = [(np.arange(4) + i) % vocab for i in range(len(lengths))]
    jres, tres = _both(pair, prompts, lengths, max_batch=2, max_len=64,
                       pool_pages=256, chunk_tokens=chunk)
    _assert_same(jres, tres)
    assert tres[0].pool.kv_copy_bytes == 0


@pytest.mark.parametrize("chunk", [1, 4, 8])
def test_shared_prefix_workload_matches_reference(pair, chunk):
    """Four requests sharing a 12-token system prefix (bucket 16): the
    hits skip the cached chunks in both packages alike."""
    vocab = pair[0].vocab_size
    shared = [(i * 5 + 2) % vocab for i in range(12)]
    prompts = [shared + [(100 + 7 * j + i) % vocab for i in range(4)]
               for j in range(4)]
    jres, tres = _both(pair, prompts, [6] * 4, drain_after_first=True,
                       max_batch=2, max_len=32, pool_pages=64, page_size=4,
                       chunk_tokens=chunk)
    _assert_same(jres, tres)
    assert tres[0].stats["prefix_hits"] == 3


def test_copy_on_write_divergence_matches_reference(pair):
    """Divergence inside a shared page copies exactly one page per
    diverging writer, in place, in both packages."""
    vocab = pair[0].vocab_size
    base = [(i * 3 + 5) % vocab for i in range(6)]
    pa, pb = base + [11, 12], base + [201, 202]
    jres, tres = _both(pair, [pa, pb, pa], [4] * 3, drain_after_first=True,
                       chunk_tokens=2, max_len=16, pool_pages=32,
                       page_size=4)
    _assert_same(jres, tres)
    te = tres[0]
    assert te.pool.cow_copy_bytes == 2 * te.pool.page_nbytes
    assert tres[1][2] == tres[1][0]


def test_streaming_exactly_once(pair):
    """Tokens streamed by a served engine thread arrive exactly once per
    position (a 4-deep stream ring drops events under backpressure; the
    handle fills those gaps from the terminal), equal to ``tokens_out``
    and to the reference's greedy tokens."""
    _, jm, jp, tm, tp = pair
    vocab = pair[0].vocab_size
    prompts = [np.arange(5 + i) % vocab for i in range(3)]
    budgets = [9, 5, 12]
    kw = dict(max_batch=2, max_len=64, pool_pages=64, chunk_tokens=4)
    want = _serve(JaxEngine(jm, jp, n_clients=1, scheduler="slot_paged",
                            **kw), prompts, budgets)
    eng = ServeEngine(tm, tp, n_clients=1, device="cpu", stream_depth=4,
                      **kw)
    thread = eng.start()
    try:
        with eng.connect(0) as session:
            handles = [session.submit_i(p, max_tokens=n)
                       for p, n in zip(prompts, budgets)]
            streams = [list(h.tokens(timeout_s=60)) for h in handles]
    finally:
        eng.stop()
        thread.join(timeout=10)
    for h, s, w in zip(handles, streams, want):
        assert sorted(p for p, _ in s) == list(range(len(w)))
        assert [t for _, t in sorted(s)] == w == list(h.response.tokens_out)
        assert h.response.fsm.state == states.REQUEST_COMPLETED


def test_cancel_mid_stream_returns_pool_to_baseline(pair):
    _, _, _, tm, tp = pair
    eng = ServeEngine(tm, tp, max_batch=2, max_len=64, n_clients=1,
                      pool_pages=32, page_size=4, chunk_tokens=4, k_max=2,
                      prefix_cache=False, device="cpu")
    baseline = eng.pool.free_pages()
    session = eng.connect(0)
    h = session.submit_i(np.arange(10) % 256, max_tokens=40)
    while not any(s.request is not None and s.generated >= 3
                  for s in eng.slots):
        eng.tick()
    assert h.cancel() is True
    eng.tick()                               # abort sweep
    r = h.wait(timeout_s=10)
    assert r.fsm.state == states.REQUEST_CANCELLED
    assert 3 <= len(r.tokens_out) < 40
    assert eng.pool.free_pages() == baseline
    assert all(s.request is None and s.fsm.state == states.BUFFER_FREE
               for s in eng.slots)
    assert eng.stats["cancelled"] == 1
