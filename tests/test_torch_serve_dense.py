"""The port's dense-ring schedulers (``slot_fused``, ``slot_chunked``,
``slot``, ``wave``) against the JAX package's engine on the mixed workload
of ``benchmarks/bench_serve.py`` (12 requests: 2/24-token generations, a
48-token prompt every fourth request; ``max_batch=2``, ``max_len=96``,
``chunk_tokens=32``), on converted weights at float32.  Per-request token
sequences must be identical and the deterministic counters equal; as a
cross-check, ``tokens_out`` and ``host_syncs`` equal what BENCH_serve.json
recorded for each scheduler.  One module-scoped run per package and
scheduler serves every test."""
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from _torch_parity import smoke_pair  # noqa: E402
from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

SCHEDULERS = ("slot_fused", "slot_chunked", "slot", "wave")
COUNTERS = ("decode_steps", "host_syncs", "prefills", "prefill_chunks",
            "cache_copy_dispatches", "admission_stall_steps",
            "fused_blocks", "served", "rejected")
BENCH = json.loads((Path(__file__).resolve().parents[1]
                    / "BENCH_serve.json").read_text())


def _workload(n_requests=12, seed=0):
    """``bench_serve.make_workload``: the same seeded mix."""
    rng = np.random.default_rng(seed)
    work = []
    for i in range(n_requests):
        long_prompt = i % 4 == 2
        long_gen = not long_prompt and i % 2 == 1
        work.append((rng.integers(0, 1000, 48 if long_prompt
                                  else (8 if long_gen else 4)),
                     24 if long_gen else (4 if long_prompt else 2)))
    return work


def _serve(eng, work, vocab):
    rids = []
    for prompt, n in work:
        r = eng.submit(0, prompt % vocab, max_tokens=n)
        assert r is not None, "intake ring full"
        rids.append(r.req_id)
    while eng.stats["served"] + eng.stats["rejected"] < len(work):
        eng.step()
    got = {}
    for _ in work:
        r = eng.get_response(0, timeout_s=10)
        assert r, "response timed out"
        got[r.req_id] = list(map(int, r.tokens_out))
    return [got[r] for r in rids]


@pytest.fixture(scope="module")
def runs():
    cfg, jm, jp, tm, tp = smoke_pair()
    work = _workload()
    kw = dict(max_batch=2, max_len=96, n_clients=1, pool_pages=512,
              page_size=16, intake_depth=len(work) + 4, chunk_tokens=32)
    out = {}
    for sched in SCHEDULERS:
        je = JaxEngine(jm, jp, scheduler=sched, **kw)
        te = ServeEngine(tm, tp, scheduler=sched, device="cpu", **kw)
        out[sched] = ((je, _serve(je, work, cfg.vocab_size)),
                      (te, _serve(te, work, cfg.vocab_size)))
    return out


@pytest.mark.parametrize("sched", SCHEDULERS)
def test_tokens_match_reference(runs, sched):
    (_, jseqs), (_, tseqs) = runs[sched]
    assert tseqs == jseqs


@pytest.mark.parametrize("sched", SCHEDULERS)
def test_counters_match_reference(runs, sched):
    (je, _), (te, _) = runs[sched]
    for key in COUNTERS:
        assert te.stats[key] == je.stats[key], key
    assert te.pool.kv_copy_bytes == je.pool.kv_copy_bytes
    assert te.pool.free_pages() == te.pool.n_pages      # all returned
    assert te.dense_cache_bytes() == je.dense_cache_bytes()


@pytest.mark.parametrize("sched", SCHEDULERS)
def test_counters_match_bench_record(runs, sched):
    """The deterministic counters BENCH_serve.json recorded for the JAX
    engine on this workload: 162 tokens for every scheduler, and
    host_syncs wave 144 / slot 97 / slot_fused 32 / slot_chunked 26."""
    (_, tseqs), rec = runs[sched][1], BENCH[sched]
    te = runs[sched][1][0]
    assert sum(map(len, tseqs)) == rec["tokens_out"] == 162
    for key in ("host_syncs", "decode_steps", "prefill_chunks",
                "cache_copy_dispatches", "admission_stall_steps"):
        assert te.stats[key] == rec[key], key
