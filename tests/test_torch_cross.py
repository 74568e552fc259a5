"""The cross-attention families in the port against the JAX package, on
the same seeded inputs at float32: ``llama-3.2-vision-11b`` (vlm_cross:
superblocks of self layers around one cross layer over image embeddings)
and ``whisper-tiny`` (enc_dec: a bidirectional encoder over audio frames,
then decoder layers of a self block and a cross block).

- One layer: cross ``attention`` over ``kv_source`` (no RoPE, no mask,
  softcap applied), ``attend_static`` over precomputed K/V (no softcap),
  ``cross_kv`` (``k_norm`` under ``qk_norm``), at T = 1, T < S and T > S.
- The model: the plan and the parameter and cache trees, ``_encode``,
  ``fill_cross_cache``, ``forward(extras)`` logits, ``loss`` and the
  gradient of every leaf, and ``prefill(extras)`` + 3 ``decode_step``s
  (tokens exact, caches 2e-5).
- Serving at weights x3 (so greedy streams vary): tokens and counters
  under every scheduler the reference runs for the family (vlm:
  ``slot_chunked``, ``slot_fused``, ``slot``, ``wave``; whisper:
  ``slot_chunked``); ``slot_paged`` refused as the reference refuses it.
- The reference's fault under enc_dec ``slot_fused`` (its tick watchdog
  swallows the encoder's ``AttributeError`` and the request completes
  with a first token never computed), and the port's refusal of enc_dec
  under ``slot``, ``slot_fused`` and ``wave`` (ROADMAP §3).
- The engine's cache plumbing with cross leaves (``_write_slot_caches``,
  ``dense_cache_bytes``), the launcher's fallback and refusal, and
  ``convert.params_from_numpy`` on both trees.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import smoke_pair  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models.layers import unembed_matrix as j_unembed  # noqa: E402
from repro.models.model import build_model as j_build  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.launch import serve as launcher  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402
from repro_torch.train import tree  # noqa: E402
from repro_torch.train.train_step import loss_and_grads  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

TOL = dict(atol=2e-5, rtol=2e-5)
VLM, WHISPER = "llama-3.2-vision-11b", "whisper-tiny"
ARCHS = (VLM, WHISPER)
COUNTERS = ("decode_steps", "host_syncs", "prefills", "prefill_chunks",
            "cache_copy_dispatches", "admission_stall_steps",
            "fused_blocks", "served", "rejected")


@pytest.fixture(scope="module")
def pairs():
    return {arch: smoke_pair(arch) for arch in ARCHS}


def _n_src(cfg) -> int:
    """Source positions of the family: image tokens or encoder frames."""
    return (cfg.encoder.num_frames if cfg.encoder is not None
            else cfg.num_image_tokens)


def _extras(cfg, B: int, seed: int, n=None) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.normal(size=(B, n or _n_src(cfg), cfg.d_model)).astype(
        np.float32)


def _cross_attn(jp, tp, arch):
    """The first cross layer's attention parameters in both packages."""
    if arch == VLM:
        return (jax.tree.map(lambda a: a[0], jp["super"]["cross"]["attn"]),
                {k: v[0] for k, v in tp["super"]["cross"]["attn"].items()})
    return (jax.tree.map(lambda a: a[0], jp["layers"]["cross"]["attn"]),
            {k: v[0] for k, v in tp["layers"]["cross"]["attn"].items()})


def _with_qk_norm(ja, ta, cfg, seed):
    """Give both packages' attention parameters random q/k norms."""
    rng = np.random.default_rng(seed)
    for n in ("q_norm", "k_norm"):
        w = (1 + 0.3 * rng.normal(size=(cfg.head_dim_,))).astype(np.float32)
        ja = {**ja, n: jnp.asarray(w)}
        ta = {**ta, n: torch.from_numpy(w)}
    return ja, ta


# ---------------------------------------------------------------------------
# One layer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("T", [1, 7, 30])
@pytest.mark.parametrize("softcap", [0.0, 2.0])
def test_cross_attention_matches_reference(pairs, arch, T, softcap):
    """``attention`` with ``kv_source``: K/V projected from the source,
    no RoPE and no mask (T = 30 exceeds every SMOKE source); the softcap
    applies, as in the reference's ``attend``."""
    cfg, _, jp, tm, tp = pairs[arch]
    jcfg = dataclasses.replace(cfg, attn_logit_softcap=softcap)
    tcfg = dataclasses.replace(tm.cfg, attn_logit_softcap=softcap)
    ja, ta = _cross_attn(jp, tp, arch)
    rng = np.random.default_rng(T)
    x = rng.normal(size=(2, T, cfg.d_model)).astype(np.float32)
    src = _extras(cfg, 2, T + 1)
    pos = np.broadcast_to(np.arange(T) + 5, (2, T)).copy()
    jo, _ = jl.attention(ja, jcfg, jnp.asarray(x), jnp.asarray(pos),
                         kv_source=jnp.asarray(src))
    to, tc = tl.attention(ta, tcfg, torch.from_numpy(x),
                          torch.from_numpy(pos),
                          kv_source=torch.from_numpy(src))
    assert tc is None
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("T", [1, 9, 30])
@pytest.mark.parametrize("qk_norm", [False, True])
def test_attend_static_and_cross_kv_match_reference(pairs, arch, T,
                                                    qk_norm):
    """``cross_kv`` of a source, then ``attend_static`` of T queries over
    it: no mask and no softcap (a softcap in the config is ignored, as
    the reference's ``_attend_static`` ignores it)."""
    cfg, _, jp, tm, tp = pairs[arch]
    jcfg = dataclasses.replace(cfg, qk_norm=qk_norm, attn_logit_softcap=5.0)
    tcfg = dataclasses.replace(tm.cfg, qk_norm=qk_norm,
                               attn_logit_softcap=5.0)
    ja, ta = _cross_attn(jp, tp, arch)
    if qk_norm:
        ja, ta = _with_qk_norm(ja, ta, cfg, seed=T)
    src = _extras(cfg, 2, T + 2)
    jkv = jmodel.cross_kv(ja, jcfg, jnp.asarray(src))
    tkv = tl.cross_kv(ta, tcfg, torch.from_numpy(src))
    for n in ("k", "v"):
        np.testing.assert_allclose(tkv[n].numpy(), np.asarray(jkv[n]), **TOL)
    x = np.random.default_rng(T + 3).normal(
        size=(2, T, cfg.d_model)).astype(np.float32)
    jo = jmodel._attend_static(ja, jcfg, jnp.asarray(x), jkv)
    to = tl.attend_static(ta, tcfg, torch.from_numpy(x), tkv)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)


def test_attention_refuses_a_ring_with_a_source(pairs):
    cfg, _, jp, tm, tp = pairs[VLM]
    _, ta = _cross_attn(jp, tp, VLM)
    cache = tm.init_cache(1, 8)["super"]["selfs"]
    with pytest.raises(ValueError, match="static cache"):
        tl.attention(ta, tm.cfg, torch.zeros(1, 1, cfg.d_model),
                     torch.zeros(1, 1, dtype=torch.long),
                     cache={n: cache[n][0, 0] for n in ("k", "v")},
                     cache_pos=0, kv_source=torch.zeros(1, 4, cfg.d_model))


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_plan_and_trees_match_reference(pairs, arch):
    cfg, jm, jp, tm, tp = pairs[arch]
    if arch == VLM:
        assert tm._vlm_plan() == jm._vlm_plan() == (1, 5, 3)
        assert build_model(get_config(VLM),
                           device="meta")._vlm_plan() == (8, 5, 3)
    got, want = tree.flatten(tp)[0], jax.tree.leaves(jp)
    assert [tuple(a.shape) for a in got] == [b.shape for b in want]
    drawn = tree.flatten(tm.init(torch.Generator().manual_seed(0)))[0]
    assert [tuple(a.shape) for a in drawn] == [b.shape for b in want]
    for extras_len in (0, 5):
        c = tm.init_cache(2, 32, extras_len=extras_len)
        jc = jm.init_cache(2, 32, extras_len=extras_len)
        assert [tuple(a.shape) for a in tree.flatten(c)[0]] == \
            [b.shape for b in jax.tree.leaves(jc)]
    assert tm.pageable is jm.pageable is False
    assert tm.chunkable is jm.chunkable is True


def test_order_puts_the_cross_layer_at_index_3(pairs):
    """A superblock runs self layers 0-2, the cross layer, then self
    layer 4; a decoder layer its self block, then its cross block."""
    tm = pairs[VLM][3]
    assert [(p, i, c) for p, _, i, _, c in tm._order()] == [
        (("super", "selfs"), (0, 0), False),
        (("super", "selfs"), (0, 1), False),
        (("super", "selfs"), (0, 2), False),
        (("super", "cross"), (0,), True),
        (("super", "selfs"), (0, 3), False)]
    wm = pairs[WHISPER][3]
    assert [c for *_, c in wm._order()] == [False, True] * 2


def test_encode_matches_reference(pairs):
    cfg, jm, jp, tm, tp = pairs[WHISPER]
    frames = _extras(cfg, 2, 11)
    want = jm._encode(jp, jnp.asarray(frames))
    with torch.no_grad():
        got = tm._encode(tp, torch.from_numpy(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="frame embeddings"):
        tm._encode(tp, None)


@pytest.mark.parametrize("arch", ARCHS)
def test_fill_cross_cache_matches_reference(pairs, arch):
    cfg, jm, jp, tm, tp = pairs[arch]
    src = _extras(cfg, 2, 12, n=9)
    want = jm.fill_cross_cache(jp, jm.init_cache(2, 16, extras_len=9),
                               jnp.asarray(src))
    c = tm.init_cache(2, 16, extras_len=9)
    with torch.no_grad():
        got = tm.fill_cross_cache(tp, c, torch.from_numpy(src))
    assert got is c
    for a, b in zip(tree.flatten(got)[0], jax.tree.leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    cross = got["cross"] if arch == WHISPER else got["super"]["cross"]
    assert float(cross["k"].abs().min(-1).values.max()) > 0


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("with_extras", [True, False])
def test_logits_match_reference(pairs, arch, with_extras):
    """Cache-less forward: cross layers over the source; without one,
    each cross layer attends over its own input, in both packages."""
    cfg, jm, jp, tm, tp = pairs[arch]
    tok = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 20))
    src = _extras(cfg, 2, 4) if with_extras else None
    jh, _, _ = jm.forward(jp, jnp.asarray(tok, jnp.int32),
                          extras=None if src is None else jnp.asarray(src))
    with torch.no_grad():
        th, _, _ = tm.forward(tp, torch.from_numpy(tok),
                              extras=None if src is None
                              else torch.from_numpy(src))
    w = np.asarray(j_unembed(jp["embed"], cfg))
    np.testing.assert_allclose(th.numpy() @ w, np.asarray(jh) @ w, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(pairs, arch):
    cfg, jm, jp, tm, tp = pairs[arch]
    tok = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 16))
    key = "image_embeds" if arch == VLM else "frame_embeds"
    src = _extras(cfg, 2, 5)
    (jloss, _), jg = jax.value_and_grad(jm.loss, has_aux=True)(
        jp, {"tokens": jnp.asarray(tok, jnp.int32), key: jnp.asarray(src)})
    loss, met, grads = loss_and_grads(
        tm, tp, {"tokens": torch.from_numpy(tok),
                 key: torch.from_numpy(src)})
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    assert float(met["aux"]) == 0.0
    got = [x.detach().numpy() for x in tree.flatten(grads)[0]]
    want = [np.asarray(x) for x in jax.tree.leaves(jg)]
    assert [a.shape for a in got] == [b.shape for b in want]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **TOL)
    cross = (grads["super"]["cross"] if arch == VLM
             else grads["layers"]["cross"])
    assert float(cross["attn"]["wk"].abs().max()) > 0
    if arch == WHISPER:
        assert float(grads["encoder"]["attn"]["wq"].abs().max()) > 0


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("B,T", [(2, 11), (1, 30)])
def test_prefill_then_decode_matches_reference(pairs, arch, B, T):
    """``prefill(extras)`` + 3 ``decode_step``s at a [B] position:
    tokens exact, every cache leaf within 2e-5.  T = 30 exceeds the
    whisper SMOKE's 24 frames: its cross reads stay non-causal."""
    cfg, jm, jp, tm, tp = pairs[arch]
    tok = np.random.default_rng(T).integers(0, cfg.vocab_size, (B, T))
    src = _extras(cfg, B, T + 1)
    jt, jc = jm.prefill(jp, jnp.asarray(tok, jnp.int32), 40,
                        extras=jnp.asarray(src))
    with torch.no_grad():
        tt, tc = tm.prefill(tp, torch.from_numpy(tok), 40,
                            extras=torch.from_numpy(src))
    got, want = [tt.tolist()], [np.asarray(jt).tolist()]
    for i in range(3):
        pos = np.full((B,), T + i, np.int32)
        jt, jc = jm.decode_step(jp, jc, jt[:, None], jnp.asarray(pos))
        with torch.no_grad():
            tt, tc = tm.decode_step(tp, tc, tt[:, None],
                                    torch.from_numpy(pos))
        got.append(tt.tolist())
        want.append(np.asarray(jt).tolist())
    assert got == want
    for a, b in zip(tree.flatten(tc)[0], jax.tree.leaves(jc)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_prefill_without_frames_raises_in_both(pairs):
    """An enc_dec prefill without frames: the reference's ``_encode``
    reads ``None.shape`` (``model.py:521, 825-826`` there); the port
    names what is missing."""
    cfg, jm, jp, tm, tp = pairs[WHISPER]
    tok = np.zeros((1, 5), np.int32)
    with pytest.raises(AttributeError):
        jm.prefill(jp, jnp.asarray(tok), 16)
    with pytest.raises(ValueError, match="frame embeddings"):
        tm.prefill(tp, torch.from_numpy(tok), 16)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------
SERVED = {VLM: ("slot_chunked", "slot_fused", "slot", "wave"),
          WHISPER: ("slot_chunked",)}
CASES = [(a, s) for a in ARCHS for s in SERVED[a]]
WORK = [(5, 12), (20, 10), (13, 16), (3, 6), (27, 9), (9, 11)]
ENGINE = dict(max_batch=3, max_len=64, n_clients=1, intake_depth=16)


@pytest.fixture(scope="module")
def scaled():
    return {arch: smoke_pair(arch, scale=3.0) for arch in ARCHS}


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
def served(scaled):
    out = {}
    for arch, sched in CASES:
        cfg, jm, jp, tm, tp = scaled[arch]
        rng = np.random.default_rng(1)
        work = [(rng.integers(0, cfg.vocab_size, n), m) for n, m in WORK]
        je = jengine.ServeEngine(jm, jp, scheduler=sched, **ENGINE)
        te = tengine.ServeEngine(tm, tp, scheduler=sched, device="cpu",
                                 **ENGINE)
        out[arch, sched] = (je, _serve(je, work), te, _serve(te, work))
    return out


@pytest.mark.parametrize("arch,sched", CASES)
def test_serving_tokens_match_reference(served, arch, sched):
    je, jseqs, te, tseqs = served[arch, sched]
    assert tseqs == jseqs
    assert [len(s) for s in tseqs] == [m for _, m in WORK]
    assert len({tuple(s) for s in tseqs}) > 1


@pytest.mark.parametrize("arch,sched", CASES)
def test_serving_counters_match_reference(served, arch, sched):
    je, _, te, _ = served[arch, sched]
    for key in COUNTERS:
        assert te.stats[key] == je.stats[key], key
    assert te.pool.kv_copy_bytes == je.pool.kv_copy_bytes
    assert te.dense_cache_bytes() == je.dense_cache_bytes()
    assert te.fault_report()["tick_failures"] == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_slot_paged_is_refused_as_in_reference(scaled, arch):
    _, jm, jp, tm, tp = scaled[arch]
    with pytest.raises(ValueError) as want:
        jengine.ServeEngine(jm, jp, scheduler="slot_paged")
    with pytest.raises(ValueError) as got:
        tengine.ServeEngine(tm, tp, scheduler="slot_paged", device="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("sched", ["slot", "slot_fused", "wave"])
def test_engine_refuses_enc_dec_where_it_would_prefill(scaled, sched):
    """A deliberate difference: the port refuses at construction what
    the reference crashes on (``wave``) or serves with an uncomputed
    first token (``slot``, ``slot_fused``)."""
    _, _, _, tm, tp = scaled[WHISPER]
    with pytest.raises(ValueError, match="scheduler='slot_chunked'"):
        tengine.ServeEngine(tm, tp, scheduler=sched, device="cpu")


def test_reference_swallows_the_encoder_fault_under_slot_fused(scaled,
                                                               monkeypatch):
    """The reference's fault, pinned: whisper under ``slot_fused`` calls
    ``Model.prefill`` without frames, ``_encode`` raises
    ``AttributeError`` (``model.py:521, 825-826`` there), the tick
    watchdog catches it, and the request still completes, with no
    prefill ever run."""
    cfg, jm, jp, _, _ = scaled[WHISPER]
    caught = []
    orig = jengine.ServeEngine._on_tick_fault

    def spy(self, exc):
        caught.append(exc)
        return orig(self, exc)

    monkeypatch.setattr(jengine.ServeEngine, "_on_tick_fault", spy)
    eng = jengine.ServeEngine(jm, jp, scheduler="slot_fused", **ENGINE)
    h = eng.submit(0, np.arange(11) % cfg.vocab_size, max_tokens=4)
    assert h is not None
    while eng.stats["served"] + eng.stats["rejected"] < 1:
        eng.step()
    r = eng.get_response(0, timeout_s=10)
    assert r and len(r.tokens_out) == 4
    assert eng.stats["prefills"] == 0
    assert [type(e) for e in caught] == [AttributeError]
    assert "shape" in str(caught[0])


# ---------------------------------------------------------------------------
# Engine plumbing, launcher, conversion
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_write_slot_caches_with_cross_leaves(pairs, arch):
    """A B=1 prefilled cache (its cross leaves filled from a source)
    lands in row 1 of a batch cache, cross leaves included, as the
    reference's ``put``."""
    cfg, jm, jp, tm, tp = pairs[arch]
    tok = np.random.default_rng(5).integers(0, 256, (1, 11)).astype(np.int32)
    src = _extras(cfg, 1, 6)
    _, jone = jm.prefill(jp, jnp.asarray(tok), 32, extras=jnp.asarray(src))
    with torch.no_grad():
        _, one = tm.prefill(tp, torch.from_numpy(tok), 32,
                            extras=torch.from_numpy(src))
    full = tm.init_cache(3, 32)
    jfull = jax.tree.map(lambda a: jnp.ones_like(a), jm.init_cache(3, 32))
    for t in tree.flatten(full)[0]:
        t.fill_(1.0)
    tengine._write_slot_caches(full, one, 1)
    want = jengine._write_slot_caches(jfull, jone, 1)
    for a, b in zip(tree.flatten(full)[0], jax.tree.leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("max_batch,max_len", [(4, 1024), (2, 6)])
def test_dense_cache_bytes_match_reference(arch, max_batch, max_len):
    """Self rings of max_len and cross K/V of the source length, summed:
    at full width, max_batch 4 and max_len 1024 in bf16, 746.6 MB for
    llama-3.2-vision-11b (537 MB of rings, 210 MB of cross K/V) and 62.0
    MB for whisper-tiny."""
    full = {VLM: 536_870_912 + 209_715_200, WHISPER: 25_165_824
            + 36_864_000}
    for get, jget in ((get_smoke_config, j_smoke), (get_config, None)):
        model = build_model(get(arch), device="meta" if jget is None
                            else "cpu")
        eng = tengine.ServeEngine.__new__(tengine.ServeEngine)
        eng.model, eng.max_batch, eng.max_len = model, max_batch, max_len
        got = eng.dense_cache_bytes()
        if jget is None:
            if (max_batch, max_len) == (4, 1024):
                assert got == full[arch]
            continue
        je = jengine.ServeEngine.__new__(jengine.ServeEngine)
        je.model = j_build(jget(arch))
        je.max_batch, je.max_len = max_batch, max_len
        assert got == je.dense_cache_bytes()


def test_launcher_falls_back_and_refuses(capsys):
    eng = launcher.main(["--smoke", "--device", "cpu", "--arch", VLM,
                         "--scheduler", "slot_paged", "--clients", "1",
                         "--requests-per-client", "2", "--max-tokens", "3"])
    assert eng.scheduler == "slot_chunked"
    assert eng.stats["served"] == 2
    assert "not pageable, falling back to slot_chunked" in \
        capsys.readouterr().out
    with pytest.raises(ValueError, match="scheduler='slot_chunked'"):
        launcher.main(["--smoke", "--device", "cpu", "--arch", WHISPER,
                       "--scheduler", "slot_fused"])


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_carries_the_tree_leaf_for_leaf(arch):
    jm = j_build(dataclasses.replace(j_smoke(arch), dtype="float32"))
    jp = jm.init(jax.random.PRNGKey(3))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    got, want = tree.flatten(tp)[0], jax.tree.leaves(jp)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
