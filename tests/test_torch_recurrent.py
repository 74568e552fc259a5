"""The recurrent families (``zamba2-2.7b``: mamba2 layers around one
shared attention block; ``rwkv6-1.6b``: uniform rwkv6 layers) in the port
against the JAX package, on the same seeded numpy inputs at float32.

- The decay linear attention both families share, in its two forms
  (scan and chunked), each against its reference counterpart within
  2e-5: with and without the rwkv bonus ``u``, decay applied at or after
  the readout, with and without an initial state, and with decays below
  the clamp.  Chunked against scan in the port, at float tolerance.
- ``mamba2_block``, ``rwkv6_time_mix`` and ``rwkv6_channel_mix`` with and
  without a cache: outputs and new caches within 2e-5.
- Both SMOKE stacks: greedy decode from a filled cache against the
  teacher-forced forward (the reference's ``test_decode_matches_forward``
  at float32, both packages alike); the parameter tree drawn from the
  reference's distributions; the engine's slot write and
  ``dense_cache_bytes`` for the recurrent leaves.
- Serving at weights x3 under ``slot``, ``slot_fused`` and ``wave``:
  tokens and counters equal; ``slot_chunked`` and ``slot_paged`` refused
  with the reference's message.
- ``ModelConfig.param_count()`` disagrees with the built tree for both
  families in both packages (a reference fault the port carries).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import smoke_pair  # noqa: E402
from repro.configs import get_config as j_config  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import linear_attention as jla  # noqa: E402
from repro.models import mamba2 as jm2  # noqa: E402
from repro.models import rwkv6 as jrw  # noqa: E402
from repro.models.layers import unembed_matrix as j_unembed  # noqa: E402
from repro.models.losses import full_logits as j_full_logits  # noqa: E402
from repro.models.model import build_model as j_build  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import linear_attention as tla  # noqa: E402
from repro_torch.models import mamba2 as tm2  # noqa: E402
from repro_torch.models import rwkv6 as trw  # noqa: E402
from repro_torch.models.layers import unembed_matrix  # noqa: E402
from repro_torch.models.losses import full_logits  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402
from repro_torch.train import tree  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

TOL = dict(atol=2e-5, rtol=2e-5)
ZAMBA, RWKV = "zamba2-2.7b", "rwkv6-1.6b"
ARCHS = (ZAMBA, RWKV)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def _trees_close(got, want, tol=TOL):
    g, w = tree.flatten(got)[0], jax.tree.leaves(want)
    assert [tuple(a.shape) for a in g] == [b.shape for b in w]
    for a, b in zip(g, w):
        _close(a, b, tol)


# ---------------------------------------------------------------------------
# The decay linear attention
# ---------------------------------------------------------------------------
def _la_inputs(seed, B=2, T=16, H=3, N=4, P=5, u=True, init=True,
               deep=False):
    """q, k, v, ld, u, S0 as numpy float32.  ``deep`` draws log decays
    well below -clamp for every clamp used here, so the clamp binds."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    ld = -np.abs(f(B, T, H, N)) * (8.0 if deep else 0.5)
    return (f(B, T, H, N), f(B, T, H, N), f(B, T, H, P), ld,
            f(H, N) * 0.3 if u else None, f(B, H, N, P) if init else None)


def _both(fn_j, fn_t, inputs, **kw):
    q, k, v, ld, u, s0 = inputs
    jy, jS = fn_j(*map(jnp.asarray, (q, k, v, ld)),
                  u=None if u is None else jnp.asarray(u),
                  initial_state=None if s0 is None else jnp.asarray(s0), **kw)
    ty, tS = fn_t(*map(torch.from_numpy, (q, k, v, ld)),
                  u=None if u is None else torch.from_numpy(u),
                  initial_state=None if s0 is None else torch.from_numpy(s0),
                  **kw)
    return (ty, tS), (jy, jS)


LA_CASES = [pytest.param(dict(u=u, decay_at_readout=r, init=i, deep=d),
                         id=f"u{int(u)}-readout{int(r)}-init{int(i)}-"
                            f"deep{int(d)}")
            for u, r in ((False, True), (True, False), (True, True),
                         (False, False))
            for i in (False, True) for d in (False, True)]


@pytest.mark.parametrize("case", LA_CASES)
def test_scan_matches_reference(case):
    inp = _la_inputs(0, u=case["u"], init=case["init"], deep=case["deep"])
    (ty, tS), (jy, jS) = _both(jla.decay_linear_attention_scan,
                               tla.decay_linear_attention_scan, inp,
                               decay_at_readout=case["decay_at_readout"],
                               clamp=5.0)
    _close(ty, jy)
    _close(tS, jS)
    assert tS.dtype == torch.float32


@pytest.mark.parametrize("case", LA_CASES)
def test_chunked_matches_reference(case):
    inp = _la_inputs(1, u=case["u"], init=case["init"], deep=case["deep"])
    (ty, tS), (jy, jS) = _both(jla.decay_linear_attention_chunked,
                               tla.decay_linear_attention_chunked, inp,
                               decay_at_readout=case["decay_at_readout"],
                               chunk=4, clamp=5.0)
    _close(ty, jy)
    _close(tS, jS)


# The forms agree "to float tolerance" (the reference's module
# docstring): the chunked one rounds exp(L) and exp(-L) apart, each to
# f32, where the scan multiplies the decays one at a time.  They agree
# for the two combinations the families call (mamba: no ``u``, decay at
# the readout; rwkv: ``u``, decay after it), not for the other two, in
# both packages (``test_the_forms_split_where_no_family_calls_them``).
SCAN_VS_CHUNKED = dict(atol=1e-4, rtol=1e-4)
AGREEING = [c for c in LA_CASES
            if c.values[0]["u"] != c.values[0]["decay_at_readout"]]


@pytest.mark.parametrize("case", AGREEING)
@pytest.mark.parametrize("chunk,clamp", [(4, 5.0), (8, 1.25), (16, 5.0)])
def test_chunked_agrees_with_scan(case, chunk, clamp):
    q, k, v, ld, u, s0 = (None if a is None else torch.from_numpy(a)
                          for a in _la_inputs(2, T=32, u=case["u"],
                                              init=case["init"],
                                              deep=case["deep"]))
    kw = dict(u=u, initial_state=s0,
              decay_at_readout=case["decay_at_readout"], clamp=clamp)
    y1, S1 = tla.decay_linear_attention_scan(q, k, v, ld, **kw)
    y2, S2 = tla.decay_linear_attention_chunked(q, k, v, ld, chunk=chunk,
                                                **kw)
    torch.testing.assert_close(y2, y1, **SCAN_VS_CHUNKED)
    torch.testing.assert_close(S2, S1, **SCAN_VS_CHUNKED)


@pytest.mark.parametrize("with_u", [True, False])
def test_the_forms_split_where_no_family_calls_them(with_u):
    """The reference's own split, carried.  With ``u`` and the decay at
    the readout, the scan ignores the bonus and the chunked form adds it;
    without ``u`` and the decay after the readout, the scan reads the
    current token with weight 1 and the chunked form not at all (its
    mask is strictly causal and it has no bonus term)."""
    q, k, v, ld, u, _ = (torch.from_numpy(a) for a in _la_inputs(5, T=8))
    u = u if with_u else None
    kw = dict(u=u, decay_at_readout=with_u, clamp=5.0)
    y_scan, _ = tla.decay_linear_attention_scan(q, k, v, ld, **kw)
    y_chunk, _ = tla.decay_linear_attention_chunked(q, k, v, ld, chunk=4,
                                                    **kw)
    assert (y_chunk - y_scan).abs().max() > 0.1
    if with_u:
        y_none, _ = tla.decay_linear_attention_scan(
            q, k, v, ld, decay_at_readout=True, clamp=5.0)
        assert torch.equal(y_scan, y_none)
    for jfn, got, extra in ((jla.decay_linear_attention_scan, y_scan, {}),
                            (jla.decay_linear_attention_chunked, y_chunk,
                             {"chunk": 4})):
        jy, _ = jfn(*map(jnp.asarray, (q.numpy(), k.numpy(), v.numpy(),
                                        ld.numpy())),
                    **{**kw, **extra,
                       "u": None if u is None else jnp.asarray(u.numpy())})
        _close(got, jy)


def test_chunked_asserts_as_reference():
    q, k, v, ld, _, _ = (None if a is None else torch.from_numpy(a)
                         for a in _la_inputs(3, T=10))
    for fn, args in ((jla.decay_linear_attention_chunked,
                      tuple(map(jnp.asarray, (q, k, v, ld)))),
                     (tla.decay_linear_attention_chunked, (q, k, v, ld))):
        with pytest.raises(AssertionError):
            fn(*args, chunk=4)                       # T % chunk != 0
        with pytest.raises(AssertionError, match="clamp"):
            fn(*args, chunk=5, clamp=20.0)           # 100 nats > 80


def test_bf16_inputs_keep_f32_state():
    q, k, v, ld, u, s0 = (torch.from_numpy(a) for a in _la_inputs(4))
    bf = [t.to(torch.bfloat16) for t in (q, k, v)]
    y, S = tla.decay_linear_attention_scan(*bf, ld, u=u, initial_state=s0)
    assert y.dtype == torch.bfloat16 and S.dtype == torch.float32
    y, S = tla.decay_linear_attention_chunked(*bf, ld, u=u, chunk=4)
    assert y.dtype == torch.bfloat16 and S.dtype == torch.float32


# ---------------------------------------------------------------------------
# The mixers
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def zamba():
    return smoke_pair(ZAMBA)


@pytest.fixture(scope="module")
def rwkv():
    return smoke_pair(RWKV)


def _cache_np(tree_, seed):
    """Random state of the cache tree's shapes, numpy float32."""
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=np.shape(v)).astype(np.float32)
            for k, v in tree_.items()}


def _x(cfg, B, T, seed):
    return np.random.default_rng(seed).normal(
        size=(B, T, cfg.d_model)).astype(np.float32)


# (T, cached): without a cache, T a multiple of the SSD chunk (8 in the
# SMOKE) takes the chunked form, any other T the scan; with a cache,
# always the scan (prefill T = 12, decode T = 1).
MIXER_CASES = [(16, False), (12, False), (12, True), (1, True), (8, True)]


@pytest.mark.parametrize("T,cached", MIXER_CASES)
def test_mamba2_block_matches_reference(zamba, T, cached):
    cfg, _, jp, _, tp = zamba
    jlp = jax.tree.map(lambda a: a[0, 1], jp["super"]["mixer"])
    tlp = {k: v[0, 1] for k, v in tp["super"]["mixer"].items()}
    x = _x(cfg, 2, T, seed=T)
    cache = (_cache_np(jm2.init_mamba_cache(cfg, 2), seed=T + 1)
             if cached else None)
    jy, jc = jm2.mamba2_block(
        jlp, cfg, jnp.asarray(x),
        None if cache is None else jax.tree.map(jnp.asarray, cache))
    with torch.no_grad():
        ty, tc = tm2.mamba2_block(
            tlp, cfg, torch.from_numpy(x),
            None if cache is None
            else {k: torch.from_numpy(v) for k, v in cache.items()})
    _close(ty, jy)
    if cached:
        _trees_close(tc, jc)
    else:
        assert tc is None and jc is None


@pytest.mark.parametrize("T,cached", [(8, False), (6, False), (6, True),
                                      (1, True)])
def test_rwkv6_mixes_match_reference(rwkv, T, cached):
    """Time-mix (chunked at T % 4 == 0 without a cache, else the scan)
    and channel-mix on the same input: outputs and cache pieces."""
    cfg, _, jp, _, tp = rwkv
    jlp = jax.tree.map(lambda a: a[1], jp["layers"]["rwkv"])
    tlp = {k: v[1] for k, v in tp["layers"]["rwkv"].items()}
    x = _x(cfg, 2, T, seed=10 + T)
    cache = (_cache_np(jrw.init_rwkv_cache(cfg, 2), seed=T) if cached
             else None)
    jc = None if cache is None else jax.tree.map(jnp.asarray, cache)
    tc = (None if cache is None
          else {k: torch.from_numpy(v) for k, v in cache.items()})
    with torch.no_grad():
        for jfn, tfn in ((jrw.rwkv6_time_mix, trw.rwkv6_time_mix),
                         (jrw.rwkv6_channel_mix, trw.rwkv6_channel_mix)):
            jy, jnew = jfn(jlp, cfg, jnp.asarray(x), jc)
            ty, tnew = tfn(tlp, cfg, torch.from_numpy(x), tc)
            _close(ty, jy)
            if cached:
                assert sorted(tnew) == sorted(jnew)
                for key in jnew:
                    _close(tnew[key], jnew[key])
            else:
                assert tnew is None and jnew is None


def test_token_shift_reads_the_cache():
    x = torch.arange(12.0).view(1, 3, 4)
    prev = torch.full((1, 4), -1.0)
    assert torch.equal(trw._token_shift(x, None)[0, 0], torch.zeros(4))
    assert torch.equal(trw._token_shift(x, prev)[0, 0], prev[0])
    assert torch.equal(trw._token_shift(x, prev)[0, 1:], x[0, :2])


# ---------------------------------------------------------------------------
# The stacks
# ---------------------------------------------------------------------------
def test_zamba_plan_and_tree(zamba):
    cfg, jm, jp, tm, tp = zamba
    assert tm._zamba_plan() == jm._zamba_plan() == (2, 2)
    assert build_model(get_config(ZAMBA), device="meta")._zamba_plan() == \
        (9, 6)
    assert sorted(tp) == sorted(jp) == ["embed", "final_norm", "shared_attn",
                                        "super"]
    order = [(p, c, i) for p, c, i, _, _ in tm._order()]
    assert order[:3] == [(("shared_attn",), ("super", "attn"), (0,)),
                         (("super",), ("super", "mamba"), (0, 0)),
                         (("super",), ("super", "mamba"), (0, 1))]
    assert len(order) == 2 * (1 + 2)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward_at_float32(arch):
    """The reference's ``test_decode_matches_forward`` at float32, in both
    packages on the same weights: prefill of the first half, then the
    rest teacher-forced one token at a time, each greedy token equal to
    the cache-less forward's argmax at its position, and the port's
    tokens equal to the reference's."""
    cfg, jm, jp, tm, tp = smoke_pair(arch, scale=3.0)
    B, T = 1, 12
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, T))
    tokens = tokens.astype(np.int32)
    jh, _, _ = jm.forward(jp, jnp.asarray(tokens))
    want = np.asarray(jnp.argmax(j_full_logits(jh, j_unembed(
        jp["embed"], cfg)), axis=-1))
    with torch.no_grad():
        th, _, _ = tm.forward(tp, torch.from_numpy(tokens))
        w = unembed_matrix(tp["embed"], tm.cfg)
        assert torch.equal(torch.argmax(full_logits(th, w), -1),
                           torch.from_numpy(want).long())
        half = T // 2
        tok, caches = tm.prefill(tp, torch.from_numpy(tokens[:, :half]),
                                 T + 4)
        jtok, jc = jm.prefill(jp, jnp.asarray(tokens[:, :half]), T + 4)
        assert int(tok[0]) == int(jtok[0]) == int(want[0, half - 1])
        for i in range(half, T):
            tok, caches = tm.decode_step(
                tp, caches, torch.from_numpy(tokens[:, i:i + 1]), i)
            jtok, jc = jm.decode_step(jp, jc, jnp.asarray(tokens[:, i:i + 1]),
                                      jnp.int32(i))
            assert int(tok[0]) == int(jtok[0]) == int(want[0, i]), i
    # At weights x3 the SSM state reaches ~500; a few of its elements
    # differ by 1e-2 after the 12 steps, 2e-5 of the largest.
    for a, b in zip(tree.flatten(caches)[0], jax.tree.leaves(jc)):
        b = np.asarray(b)
        _close(a, b, dict(atol=1e-4 * np.abs(b).max(), rtol=1e-4))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_draws_the_reference_distributions(arch):
    """Each leaf of ``Model.init`` at a widened SMOKE config against the
    reference's ``ParamBuilder``: zeros (``conv_b``) and ones (the layer
    norms) exactly, every other leaf's mean and std within the sampling
    error of its size (``zero=``, ``scale=``, ``fan_in=``)."""
    wide = dict(d_model=128, d_ff=256, dtype="float32")
    cfg = dataclasses.replace(get_smoke_config(arch), **wide)
    jcfg = dataclasses.replace(j_smoke(arch), **wide)
    tp = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    jp = j_build(jcfg).init(jax.random.PRNGKey(0))
    got, want = tree.flatten(tp)[0], jax.tree.leaves(jp)
    assert [tuple(a.shape) for a in got] == [b.shape for b in want]
    for a, b in zip(got, want):
        a, b = a.double().numpy(), np.asarray(b, np.float64)
        if np.all(b == b.flat[0]):
            assert np.all(a == b.flat[0]), b.flat[0]
            continue
        sd = b.std()
        assert abs(a.mean() - b.mean()) < 6 * sd * np.sqrt(2 / a.size)
        assert abs(a.std() / sd - 1) < 0.25, (a.shape, a.std(), sd)


@pytest.mark.parametrize("arch", ARCHS)
def test_write_slot_caches_places_the_state(arch):
    """A B=1 prefilled recurrent cache lands in row 1 of a batch cache
    (conv, ssm and zamba's rings; shift_tm, shift_cm and wkv), exactly as
    the reference's ``put``."""
    _, jm, jp, tm, tp = smoke_pair(arch)
    tok = np.random.default_rng(5).integers(0, 256, (1, 11)).astype(np.int32)
    _, jone = jm.prefill(jp, jnp.asarray(tok), 32)
    with torch.no_grad():
        _, one = tm.prefill(tp, torch.from_numpy(tok), 32)
    full = tm.init_cache(3, 32)
    for t in tree.flatten(full)[0]:
        t.fill_(1.0)
    jfull = jax.tree.map(jnp.ones_like, jm.init_cache(3, 32))
    tengine._write_slot_caches(full, one, 1)
    _trees_close(full, jengine._write_slot_caches(jfull, jone, 1))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("max_batch,max_len", [(4, 1024), (2, 6)])
def test_dense_cache_bytes_match_reference(arch, max_batch, max_len):
    """``init_cache``'s leaves summed on the meta device, as the reference
    sums its abstract cache, at SMOKE and full width (zamba2-2.7b at
    B=4, max_len 1024: 9 rings of 2 x 4 x 1024 x 32 x 80 bf16 and 54
    layers of conv (3 x 5248 bf16) and ssm (80 x 64 x 64 f32) state,
    667 MB)."""
    for get in (get_smoke_config, get_config):
        cfg = get(arch)
        eng = tengine.ServeEngine.__new__(tengine.ServeEngine)
        eng.model = build_model(cfg, device="meta")
        eng.max_batch, eng.max_len = max_batch, max_len
        je = jengine.ServeEngine.__new__(jengine.ServeEngine)
        je.model = j_build(j_config(arch) if get is get_config
                           else j_smoke(arch))
        je.max_batch, je.max_len = max_batch, max_len
        assert eng.dense_cache_bytes() == je.dense_cache_bytes()
    if arch == ZAMBA and (max_batch, max_len) == (4, 1024):
        rings = 9 * 2 * 4 * 1024 * 32 * 80 * 2
        state = 54 * 4 * (3 * 5248 * 2 + 80 * 64 * 64 * 4)
        assert eng.dense_cache_bytes() == rings + state == 667_404_288


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------
SCHEDULERS = ("slot", "slot_fused", "wave")
WORK = [(5, 12), (20, 10), (13, 16), (3, 6), (27, 9), (9, 11)]
ENGINE = dict(max_batch=3, max_len=64, n_clients=1, intake_depth=16)
COUNTERS = ("decode_steps", "host_syncs", "prefills", "prefill_chunks",
            "cache_copy_dispatches", "admission_stall_steps",
            "fused_blocks", "served", "rejected")


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
def served():
    """Both families at weights x3 under each scheduler, in both
    packages."""
    out = {}
    for arch in ARCHS:
        cfg, jm, jp, tm, tp = smoke_pair(arch, scale=3.0)
        rng = np.random.default_rng(1)
        work = [(rng.integers(0, cfg.vocab_size, n), m) for n, m in WORK]
        for sched in SCHEDULERS:
            je = jengine.ServeEngine(jm, jp, scheduler=sched, **ENGINE)
            te = tengine.ServeEngine(tm, tp, scheduler=sched, device="cpu",
                                     **ENGINE)
            out[arch, sched] = (je, _serve(je, work), te, _serve(te, work))
    return out


@pytest.mark.parametrize("sched", SCHEDULERS)
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_tokens_match_reference(served, arch, sched):
    je, jseqs, te, tseqs = served[arch, sched]
    assert tseqs == jseqs
    assert [len(s) for s in tseqs] == [m for _, m in WORK]
    # Greedy streams that vary: the state carries the prompt.
    assert len({t for s in tseqs for t in s}) > 10


@pytest.mark.parametrize("sched", SCHEDULERS)
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_counters_match_reference(served, arch, sched):
    je, _, te, _ = served[arch, sched]
    for key in COUNTERS:
        assert te.stats[key] == je.stats[key], key
    assert te.pool.kv_copy_bytes == je.pool.kv_copy_bytes
    assert te.dense_cache_bytes() == je.dense_cache_bytes()


@pytest.mark.parametrize("sched", ["slot_chunked", "slot_paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_and_paged_are_refused_as_in_reference(arch, sched):
    _, jm, jp, tm, tp = smoke_pair(arch)
    assert not (tm.chunkable or tm.pageable or jm.chunkable or jm.pageable)
    with pytest.raises(ValueError) as want:
        jengine.ServeEngine(jm, jp, scheduler=sched)
    with pytest.raises(ValueError) as got:
        tengine.ServeEngine(tm, tp, scheduler=sched, device="cpu")
    assert str(got.value) == str(want.value)
    with pytest.raises(NotImplementedError) as want:
        jm.prefill_chunk_into(jp, None, jnp.zeros((1, 4), jnp.int32),
                              jnp.zeros(1, jnp.int32),
                              jnp.ones(1, jnp.int32))
    with pytest.raises(NotImplementedError) as got:
        tm.prefill_chunk_into(tp, None, torch.zeros((1, 4), dtype=torch.int32),
                              torch.zeros(1, dtype=torch.int32),
                              torch.ones(1, dtype=torch.int32))
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# param_count (ROADMAP §3)
# ---------------------------------------------------------------------------
BUILT = {ZAMBA: 2_340_750_240, RWKV: 1_583_941_632}
CLAIMED = {ZAMBA: 5_092_515_840, RWKV: 1_385_168_896}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_differs_from_the_built_tree(arch):
    """``ModelConfig.param_count()`` miscounts both families in both
    packages (zamba: an MLP in every mamba layer, which the tree does not
    have; rwkv: the decay LoRA and the mixes miscounted).  The port keeps
    the reference's formula; the built tree's count is the reference's
    ``init`` traced for shapes alone."""
    jtree = jax.eval_shape(j_build(j_config(arch)).init,
                           jax.random.PRNGKey(0))
    built = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jtree))
    assert built == BUILT[arch]
    assert get_config(arch).param_count() == j_config(arch).param_count() \
        == CLAIMED[arch] != built
