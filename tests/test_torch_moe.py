"""The port's mixture-of-experts family against the JAX package's, on the
same numpy-seeded inputs and converted weights at float32
(``smoke_pair("olmoe-1b-7b")`` and ``"arctic-480b"``: 8 experts, top-4 and
top-2 with arctic's dense residual MLP).

- ``moe_block`` against ``repro.models.moe._moe_local`` with capacity
  binding, exact router ties and tokens whose every choice is dropped:
  outputs within 2e-5, aux within 1e-6; ``_capacity`` equal for every
  token count.
- Model logits, and ``loss`` with its gradients (the aux term included),
  within 2e-5 of JAX.
- These comparisons of values run at the initializer's own scale.  At
  ``smoke_pair(scale=3)`` the two packages' float32 rounding is amplified
  by the larger activations (one arctic expert output element 2.9e-5
  apart, smollm's logits ~2e-4), while the serving tests below need
  ``scale=3`` for streams that vary.
- ``params_from_numpy`` carries the MoE tree over leaf by leaf, and
  ``Model.init`` draws the same tree with the reference's shapes and
  fan-in scales.
- Greedy tokens and engine counters equal ``repro``'s under all five
  schedulers, in a run where capacity binds and an idle or dead row sits
  ahead of a live one; with the old ``lens = cache_pos + T`` rule the
  same ``slot_paged`` run gives a different live token.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import smoke_pair  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.layers import unembed_matrix as j_unembed  # noqa: E402
from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.train import tree  # noqa: E402
from repro_torch.train.train_step import loss_and_grads  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

TOL = dict(atol=2e-5, rtol=2e-5)
ARCHS = ("olmoe-1b-7b", "arctic-480b")
SCHEDULERS = ("slot_paged", "slot_chunked", "slot_fused", "slot", "wave")
COUNTERS = ("decode_steps", "host_syncs", "prefills", "prefill_chunks",
            "prefix_hits", "prefill_tokens_saved", "cache_copy_dispatches",
            "admission_stall_steps", "fused_blocks", "served", "rejected")


@pytest.fixture(scope="module", params=ARCHS)
def pair1(request):
    return smoke_pair(request.param)


def _moe0(jp, tp):
    """Layer 0's ``moe`` subtree in both packages."""
    return (jax.tree.map(lambda a: np.asarray(a[0]), jp["layers"]["moe"]),
            {k: v[0] for k, v in tp["layers"]["moe"].items()})


def _dropped(cfg, eids: np.ndarray) -> np.ndarray:
    """Choices dropped per token: an expert's choices past its capacity,
    FIFO by token id then rank (counted here independently)."""
    t, k = eids.shape
    C = jmoe._capacity(t, cfg)
    seen = np.zeros(cfg.moe.num_experts, int)
    out = np.zeros(t, int)
    for i, e in enumerate(eids.reshape(-1)):
        out[i // k] += seen[e] >= C
        seen[e] += 1
    return out


BLOCK_CASES = ("random", "router_tie", "uniform_router", "repeated_tokens")


def _block_inputs(case: str, cfg, jm0, t=16, d=64):
    """(x [2, t/2, d], router) for one case; the router is layer 0's,
    edited for the tie cases."""
    rng = np.random.default_rng(BLOCK_CASES.index(case))
    x = rng.normal(size=(2, t // 2, d)).astype(np.float32)
    router = np.array(jm0["router"])
    if case == "uniform_router":
        # Every probability equal: the top k are experts 0..k-1 (lower
        # ids win every tie), so those fill and later tokens drop all.
        router[:] = 0.0
    elif case == "router_tie":
        router[:, 5] = router[:, 2]          # experts 2 and 5 always tie
    elif case == "repeated_tokens":
        x[:] = x[0, 0]                       # every token routes alike
    return x, router


@pytest.mark.parametrize("case", BLOCK_CASES)
def test_moe_block_matches_reference(pair1, case):
    cfg, _, jp, tm, tp = pair1
    jm0, tm0 = _moe0(jp, tp)
    x, router = _block_inputs(case, cfg, jm0)
    jparams = {**jm0, "router": router}
    tparams = {**tm0, "router": torch.from_numpy(router)}
    jout, jaux = jmoe._moe_local(cfg, jnp.asarray(x),
                                 jax.tree.map(jnp.asarray, jparams))
    tout, taux = tmoe.moe_block(tparams, tm.cfg, torch.from_numpy(x))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    assert abs(float(taux) - float(jaux)) <= 1e-6
    gates, eids, _ = tmoe._route(tm.cfg, torch.from_numpy(x.reshape(16, -1)),
                                 tparams["router"])
    jg, je, _ = jmoe._route(cfg, jnp.asarray(x.reshape(16, -1)),
                            jnp.asarray(router))
    np.testing.assert_array_equal(eids.numpy(), np.asarray(je))
    np.testing.assert_allclose(gates.numpy(), np.asarray(jg), **TOL)
    dropped = _dropped(cfg, np.asarray(je))
    k = cfg.moe.top_k
    if case in ("uniform_router", "repeated_tokens"):
        assert dropped.sum() > 0 and (dropped == k).any()
    if case == "uniform_router":
        assert (eids.numpy() == np.arange(k)).all()
        # A token whose every choice was dropped adds nothing.
        np.testing.assert_array_equal(tout.numpy().reshape(16, -1)[
            dropped == k], 0.0)
    if case == "router_tie":
        # The tie decides a choice: expert 2 chosen, 5 not, somewhere.
        e = eids.numpy()
        assert ((e == 2).any(1) & ~(e == 5).any(1)).any()


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_matches_reference(arch):
    """``int()`` truncation for every dispatch size up to 1100 tokens, at
    the SMOKE and the full-width expert counts."""
    for cfg in (get_smoke_config(arch), get_config(arch)):
        for t in range(1, 1100):
            assert tmoe._capacity(t, cfg) == jmoe._capacity(t, cfg), t


def test_mesh_is_refused(pair1):
    _, _, jp, tm, tp = pair1
    _, tm0 = _moe0(jp, tp)
    with pytest.raises(NotImplementedError, match="mesh"):
        tmoe.moe_block(tm0, tm.cfg, torch.zeros(1, 2, 64), mesh=object())


def test_logits_match_reference(pair1):
    cfg, jm, jp, tm, tp = pair1
    tok = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 12))
    jh, _, jaux = jm.forward(jp, jnp.asarray(tok, jnp.int32))
    with torch.no_grad():
        th, _, taux = tm.forward(tp, torch.from_numpy(tok))
    w = np.asarray(j_unembed(jp["embed"], cfg))
    np.testing.assert_allclose(th.numpy() @ w, np.asarray(jh) @ w, **TOL)
    assert abs(float(taux) - float(jaux)) <= 1e-6
    assert float(taux) > 0


def test_loss_and_grads_match_reference(pair1):
    cfg, jm, jp, tm, tp = pair1
    tok = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 16))
    (jloss, jmet), jg = jax.value_and_grad(jm.loss, has_aux=True)(
        jp, {"tokens": jnp.asarray(tok, jnp.int32)})
    loss, met, grads = loss_and_grads(tm, tp,
                                      {"tokens": torch.from_numpy(tok)})
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    np.testing.assert_allclose(float(met["xent"]), float(jmet["xent"]),
                               **TOL)
    assert abs(float(met["aux"]) - float(jmet["aux"])) <= 1e-6
    assert float(loss) == pytest.approx(
        float(met["xent"]) + cfg.moe.aux_loss_weight * float(met["aux"]))
    got = [x.detach().numpy() for x in tree.flatten(grads)[0]]
    want = [np.asarray(x) for x in jax.tree.leaves(jg)]
    assert [a.shape for a in got] == [b.shape for b in want]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **TOL)
    # The aux loss and the gates reach the router.
    assert float(grads["layers"]["moe"]["router"].abs().max()) > 0


def test_params_from_numpy_carries_the_moe_tree(pair1):
    _, _, jp, _, _ = pair1
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    got, want = tree.flatten(tp)[0], jax.tree.leaves(jp)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert set(tp["layers"]) == set(jp["layers"])
    assert set(tp["layers"]["moe"]) == {"router", "wi_gate", "wi_up", "wo"}


def test_init_draws_the_reference_tree(pair1):
    """``Model.init`` gives the JAX package's tree: the same leaves and
    shapes, expert weights at fan-in scale (d for router and the input
    projections, d_ff_expert for ``wo``)."""
    cfg, jm, jp, tm, _ = pair1
    params = tm.init(torch.Generator().manual_seed(0))
    got, want = tree.flatten(params)[0], jax.tree.leaves(jp)
    assert [tuple(a.shape) for a in got] == [b.shape for b in want]
    moe = params["layers"]["moe"]
    d, fe = cfg.d_model, cfg.moe.d_ff_expert
    for name, fan_in in (("router", d), ("wi_gate", d), ("wi_up", d),
                         ("wo", fe)):
        assert float(moe[name].std()) == pytest.approx(fan_in ** -0.5,
                                                       rel=0.1), name
    assert ("dense" in params["layers"]) == cfg.moe.dense_residual


# ---------------------------------------------------------------------------
# Serving: all five schedulers against the reference
# ---------------------------------------------------------------------------
WORK_SHAPES = [(5, 3), (9, 12), (3, 8), (14, 2), (6, 10), (4, 5)]
ENGINE = dict(max_batch=2, max_len=48, n_clients=1, pool_pages=64,
              page_size=4, chunk_tokens=4, k_max=4)


def _work(vocab):
    rng = np.random.default_rng(5)
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


@pytest.fixture(scope="module")
def olmoe3():
    return smoke_pair("olmoe-1b-7b", scale=3.0)


@pytest.fixture(scope="module")
def served(olmoe3):
    """One run per scheduler and package, recording (port side) every
    dispatch's MoE choices dropped and, under a write mask, whether an
    unwritten row sat ahead of a written one."""
    cfg, jm, jp, tm, tp = olmoe3
    work = _work(cfg.vocab_size)
    out = {}
    for sched in SCHEDULERS:
        seen = {"dropped": 0, "unwritten_ahead": 0}
        route, lens = tmoe._route, tl.written_lens

        def counted_route(cfg_, x, w):
            gates, eids, aux = route(cfg_, x, w)
            seen["dropped"] += int(_dropped(cfg_, eids.numpy()).sum())
            return gates, eids, aux

        def counted_lens(cp, wm):
            if wm is not None:
                wrote = wm.any(1).tolist()
                seen["unwritten_ahead"] += any(
                    not wrote[i] and any(wrote[i + 1:])
                    for i in range(len(wrote)))
            return lens(cp, wm)

        je = JaxEngine(jm, jp, scheduler=sched, **ENGINE)
        jseqs = _serve(je, work)
        tmoe._route, tl.written_lens = counted_route, counted_lens
        try:
            te = ServeEngine(tm, tp, scheduler=sched, device="cpu", **ENGINE)
            tseqs = _serve(te, work)
        finally:
            tmoe._route, tl.written_lens = route, lens
        out[sched] = (je, jseqs, te, tseqs, seen)
    return out


@pytest.mark.parametrize("sched", SCHEDULERS)
def test_serving_tokens_match_reference(served, sched):
    _, jseqs, _, tseqs, seen = served[sched]
    assert tseqs == jseqs
    assert [len(s) for s in tseqs] == [m for _, m in WORK_SHAPES]
    assert seen["dropped"] > 0                   # capacity bound


@pytest.mark.parametrize("sched", SCHEDULERS)
def test_serving_counters_match_reference(served, sched):
    je, _, te, _, _ = served[sched]
    for key in COUNTERS:
        assert te.stats[key] == je.stats[key], key
    assert te.pool.kv_copy_bytes == je.pool.kv_copy_bytes


def test_an_unwritten_row_sits_ahead_of_a_live_one(served):
    """In the slot_paged run some dispatch has a row that writes nothing
    (idle or dead) before a row that writes: its tokens claim capacity
    ahead of the live row's."""
    assert served["slot_paged"][4]["unwritten_ahead"] > 0


def test_old_lens_rule_changes_a_live_token(served, olmoe3, monkeypatch):
    """The same slot_paged run with the rule the port had before: keys
    bounded by ``lens = cache_pos + T`` alone, rows that wrote nothing
    left at the kernel's 0.  An unwritten row's hidden state then differs
    from the reference's, takes other experts' capacity, and a live
    greedy token changes."""
    _, jseqs, _, tseqs, _ = served["slot_paged"]
    _, _, _, tm, tp = olmoe3
    monkeypatch.setattr(tl, "written_lens", lambda cp, write_mask: None)
    te = ServeEngine(tm, tp, scheduler="slot_paged", device="cpu", **ENGINE)
    old = _serve(te, _work(tm.cfg.vocab_size))
    assert tseqs == jseqs and old != jseqs


def test_build_model_names_what_is_left():
    """The next refused families are named; gemma (slice 8) builds."""
    for arch, fam in (("zamba2-2.7b", "zamba_hybrid"),
                      ("llama-3.2-vision-11b", "vlm_cross")):
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        with pytest.raises(NotImplementedError, match=fam):
            build_model(cfg, device="cpu")
    assert build_model(get_smoke_config("olmoe-1b-7b"), device="cpu")
    assert build_model(get_smoke_config("gemma3-27b"), device="cpu")

