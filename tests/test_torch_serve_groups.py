"""The registry's last three architectures served by the port against the
JAX package's engine, at float32 on converted weights
(``smoke_pair(scale=3)``: streams that vary token to token): SMOKE
``qwen3-14b`` widened to 10/2 heads and SMOKE ``arctic-480b`` to 14/2, so
each kv head carries the full-width GQA group (qwen3's 40/8 is 5, arctic's
56/8 is 7), and SMOKE ``stablelm-3b`` as it is (4/4 heads, g 1), under
``slot_paged`` and ``slot_fused``.  Greedy tokens and the engine's
deterministic counters must be identical.  The reference's tokens are
computed once for the module."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from _torch_parity import smoke_pair  # noqa: E402
from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

# arch: (config overrides, query heads per kv head)
CASES = {
    "qwen3-14b": (dict(num_heads=10, num_kv_heads=2), 5),
    "arctic-480b": (dict(num_heads=14, num_kv_heads=2), 7),
    "stablelm-3b": ({}, 1),
}
SCHEDULERS = ("slot_paged", "slot_fused")
COUNTERS = ("decode_steps", "host_syncs", "prefills", "prefill_chunks",
            "prefix_hits", "prefill_tokens_saved", "cache_copy_dispatches",
            "admission_stall_steps", "fused_blocks", "served", "rejected")
# (prompt tokens, new tokens): prompts shorter than, equal to and past a
# 4-token chunk and page; two rows at a time, so rows join mid-decode.
WORK_SHAPES = [(5, 3), (9, 12), (3, 8), (14, 2), (6, 10), (4, 5)]
ENGINE = dict(max_batch=2, max_len=48, n_clients=1, pool_pages=64,
              page_size=4, chunk_tokens=4, k_max=4)


def _work(vocab):
    rng = np.random.default_rng(7)
    return [(rng.integers(0, vocab, n), m) for n, m in WORK_SHAPES]


def _serve(eng, work):
    rids = [eng.submit(0, p, max_tokens=m).req_id for p, m in work]
    while eng.stats["served"] + eng.stats["rejected"] < len(work):
        eng.step()
    got = {}
    for _ in work:
        r = eng.get_response(0, timeout_s=10)
        assert r, "response timed out"
        got[r.req_id] = list(map(int, r.tokens_out))
    return [got[r] for r in rids]


@pytest.fixture(scope="module", params=sorted(CASES))
def served(request):
    """{scheduler: (jax engine, jax tokens, port engine, port tokens)}
    for one arch, and its config."""
    overrides, _ = CASES[request.param]
    cfg, jm, jp, tm, tp = smoke_pair(request.param, scale=3.0, **overrides)
    work = _work(cfg.vocab_size)
    out = {}
    for sched in SCHEDULERS:
        je = JaxEngine(jm, jp, scheduler=sched, **ENGINE)
        te = ServeEngine(tm, tp, scheduler=sched, device="cpu", **ENGINE)
        out[sched] = (je, _serve(je, work), te, _serve(te, work))
    return request.param, tm.cfg, out


def test_configs_carry_the_full_width_groups(served):
    arch, cfg, _ = served
    assert cfg.num_heads // cfg.num_kv_heads == CASES[arch][1]


@pytest.mark.parametrize("sched", SCHEDULERS)
def test_serving_tokens_match_reference(served, sched):
    _, _, out = served
    _, jseqs, _, tseqs = out[sched]
    assert tseqs == jseqs
    assert [len(s) for s in tseqs] == [m for _, m in WORK_SHAPES]
    assert len({t for s in tseqs for t in s}) > 3      # streams vary


@pytest.mark.parametrize("sched", SCHEDULERS)
def test_serving_counters_match_reference(served, sched):
    _, _, out = served
    je, _, te, _ = out[sched]
    for key in COUNTERS:
        assert te.stats[key] == je.stats[key], key
    assert te.pool.kv_copy_bytes == je.pool.kv_copy_bytes
