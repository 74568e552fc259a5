"""The local:global family (``gemma3-27b``) in the port against the JAX
package, on the same seeded inputs at float32.

- ``layers.embed``'s ``sqrt(d_model)`` scale, cast to the activations'
  dtype first (73.5 in bf16 at gemma3-27b's width).
- One windowed layer over an 8-slot ring (the SMOKE's W = 8): lockstep
  (int ``cache_pos``) and per-row ([B] ``cache_pos``), with and without a
  write mask, for T = 1, T < S and T > S, at counts below, at and past
  the ring.  The T > S cases hold duplicate slots (the last writer wins,
  a masked last writer keeps the slot's old value) and queries whose
  range of keys is empty (the uniform V mean).  Outputs and rings match
  to 2e-5: the port's plain ring read against the reference's jnp one.
- The whole SMOKE stack: logits; ``Model.loss`` and its gradients; the
  ring path of both packages equal to each other and, past W, different
  from the cache-less forward (ROADMAP §3, "Found in the reference").
- Serving at weights x3 (so greedy streams vary) under ``slot_chunked``,
  ``slot_fused``, ``slot`` and ``wave`` with the engine's own 16-token
  chunks and prompts that wrap the local rings: tokens and counters
  (``dense_cache_bytes`` and ``kv_copy_bytes`` included) equal;
  ``slot_paged`` refused as the reference refuses it.
- The two engine repairs the heterogeneous cache needs:
  ``_write_slot_caches`` walks the cache tree, and ``dense_cache_bytes``
  sums ``init_cache``'s leaves for every family the port builds.
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
from repro.models.layers import unembed_matrix as j_unembed  # noqa: E402
from repro.models.model import build_model as j_build  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402
from repro_torch.train import tree  # noqa: E402
from repro_torch.train.train_step import loss_and_grads  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

TOL = dict(atol=2e-5, rtol=2e-5)
ARCH = "gemma3-27b"
W = 8                                   # the SMOKE's sliding window
COUNTERS = ("decode_steps", "host_syncs", "prefills", "prefill_chunks",
            "cache_copy_dispatches", "admission_stall_steps",
            "fused_blocks", "served", "rejected")


@pytest.fixture(scope="module")
def pair():
    return smoke_pair(ARCH)


def _local0(jp, tp):
    """The first local layer's attention parameters in both packages."""
    return (jax.tree.map(lambda a: a[0, 0], jp["super"]["local"]["attn"]),
            {k: v[0, 0] for k, v in tp["super"]["local"]["attn"].items()})


# ---------------------------------------------------------------------------
# Embedding scale
# ---------------------------------------------------------------------------
def test_embedding_scale_matches_reference(pair):
    cfg, _, jp, tm, tp = pair
    tok = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 9))
    want = np.asarray(jl.embed(jp["embed"], jnp.asarray(tok), cfg))
    got = tl.embed(tp["embed"], torch.from_numpy(tok), tm.cfg).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    raw = tp["embed"]["table"][torch.from_numpy(tok)].numpy()
    np.testing.assert_allclose(got, raw * cfg.d_model ** 0.5, rtol=1e-6)


def test_embedding_scale_is_cast_first_in_bf16():
    """gemma3-27b's sqrt(5376) = 73.32... is 73.5 in bf16, in both."""
    cfg = get_config(ARCH)
    assert cfg.compute_dtype == torch.bfloat16
    table = {"table": torch.ones(4, cfg.d_model, dtype=torch.bfloat16)}
    got = tl.embed(table, torch.tensor([[1]]), cfg)
    assert float(got[0, 0, 0]) == 73.5
    assert float(jnp.asarray(cfg.d_model ** 0.5, jnp.bfloat16)) == 73.5
    smol = get_config("smollm-135m")
    assert float(tl.embed({"table": torch.ones(4, smol.d_model)},
                          torch.tensor([[1]]), smol)[0, 0, 0]) == 1.0


# ---------------------------------------------------------------------------
# One windowed layer over a ring
# ---------------------------------------------------------------------------
def _ring(cfg, B, size, seed):
    rng = np.random.default_rng(seed)
    shape = (B, size, cfg.num_kv_heads, cfg.head_dim_)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


def _run_both(pair, T, cache_pos, size, write_mask=None, seed=0):
    cfg, _, jp, tm, tp = pair
    ja, ta = _local0(jp, tp)
    B = 2 if isinstance(cache_pos, int) else len(cache_pos)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, cfg.d_model)).astype(np.float32)
    cp = np.asarray(cache_pos)
    pos = (cp[..., None] if cp.ndim else cp) + np.arange(T)
    pos = np.broadcast_to(pos, (B, T)).copy()
    rk, rv = _ring(cfg, B, size, seed + 1)
    jcp = (jnp.int32(cache_pos) if isinstance(cache_pos, int)
           else jnp.asarray(cache_pos, jnp.int32))
    jo, jc = jl.attention(
        ja, cfg, jnp.asarray(x), jnp.asarray(pos), window=W,
        cache={"k": jnp.asarray(rk), "v": jnp.asarray(rv)}, cache_pos=jcp,
        write_mask=None if write_mask is None else jnp.asarray(write_mask))
    tcache = {"k": torch.from_numpy(rk.copy()),
              "v": torch.from_numpy(rv.copy()),
              "block": tm._ring_block(B, size)}
    tcp = (cache_pos if isinstance(cache_pos, int)
           else torch.tensor(cache_pos, dtype=torch.int32))
    to, _ = tl.attention(
        ta, tm.cfg, torch.from_numpy(x), torch.from_numpy(pos), window=W,
        cache=tcache, cache_pos=tcp,
        write_mask=None if write_mask is None
        else torch.from_numpy(write_mask))
    for n in ("k", "v"):
        np.testing.assert_allclose(tcache[n].numpy(), np.asarray(jc[n]),
                                   **TOL)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    return to.numpy(), np.asarray(jo)


# (T, cache_pos): lockstep writes of the same slots in every row; below,
# at and past the ring, T > S (the first T - S queries see nothing), and
# a ring of 4 slots under the window of 8 (max_len < W).
LOCKSTEP = [(6, 0, 8), (8, 0, 8), (12, 0, 8), (24, 0, 8), (1, 5, 8),
            (1, 13, 8), (3, 6, 8), (16, 5, 8), (5, 2, 4), (1, 9, 4)]


@pytest.mark.parametrize("T,cp,size", LOCKSTEP)
def test_windowed_layer_lockstep(pair, T, cp, size):
    _run_both(pair, T, cp, size, seed=T + cp)


# (T, [(cache_pos, n_valid)] per row): decode past the ring; a chunk
# shorter than the ring with a padded tail, an idle row and a wrap; a
# chunk longer than the ring (duplicate slots) whose rows wrote all of
# it, most of it, a tail shorter than T - S (its valid tokens' slots all
# have a masked last writer) and nothing.
PER_ROW = {
    "decode": (1, [(3, 1), (7, 1), (8, 0), (20, 1)]),
    "chunk_T4": (4, [(2, 4), (6, 2), (13, 0), (0, 3)]),
    "chunk_T16": (16, [(0, 16), (5, 11), (20, 3), (9, 0)]),
    "chunk_T16_late": (16, [(32, 16), (40, 9), (47, 16), (3, 1)]),
}


@pytest.mark.parametrize("name", sorted(PER_ROW))
@pytest.mark.parametrize("masked", [True, False])
def test_windowed_layer_per_row(pair, name, masked):
    T, rows = PER_ROW[name]
    cp = [c for c, _ in rows]
    nval = np.array([n for _, n in rows])
    wm = np.arange(T)[None, :] < nval[:, None]
    _run_both(pair, T, cp, 8, wm if masked else None, seed=len(name))


def test_ring_read_without_keys_is_the_uniform_mean(pair):
    """A T=16 chunk over an 8-slot ring: queries 0..7 of a full row see
    nothing (their positions left the ring) and get the mean of the
    row's 8 slots, as the reference's softmax over all-masked scores."""
    to, _ = _run_both(pair, 16, [0, 4], 8,
                      np.ones((2, 16), bool), seed=3)
    assert not np.allclose(to[:, 0], to[:, 8])
    np.testing.assert_allclose(to[:, 0], to[:, 7], **TOL)


@pytest.mark.parametrize("T,window", [(1, 8), (4, 8), (16, 8), (16, 3)])
def test_ring_plain_versions_agree(T, window):
    """``paged_attention_split_ref`` (the kernel's split-KV arithmetic)
    equals ``paged_attention_ref`` under the ring bound, zero queries
    included, with and without kv_lens."""
    rng = np.random.default_rng(T + window)
    B, size, ps, Hkv, g, hd = 4, 8, 4, 2, 2, 16
    f = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    k = f(rng.normal(size=(B * size // ps, ps, Hkv, hd)))
    v = f(rng.normal(size=(B * size // ps, ps, Hkv, hd)))
    q = f(rng.normal(size=(B, T, Hkv * g, hd)))
    block = torch.arange(B * size // ps, dtype=torch.int32).view(B, -1)
    cp = torch.tensor([0, 5, 13, 30], dtype=torch.int32)
    lens = cp + T
    for kv_lens in (None, cp + torch.tensor([0, T, 1, T],
                                            dtype=torch.int32)):
        kw = dict(kv_lens=kv_lens, ring=size, window=window)
        want = ref.paged_attention_ref(q, k, v, block, lens, **kw)
        for split_keys in (4, 8):
            got = ref.paged_attention_split_ref(q, k, v, block, lens,
                                                split_keys, **kw)
            np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    assert float(want[0].abs().max()) == 0.0      # n = 0: no key at all


def test_windowed_paged_cache_is_refused(pair):
    _, _, jp, tm, tp = pair
    _, ta = _local0(jp, tp)
    cache = {"pages_k": torch.zeros(3, 4, 1, 2, 16),
             "pages_v": torch.zeros(3, 4, 1, 2, 16), "layer": 0,
             "block": torch.zeros(1, 2, dtype=torch.int32)}
    with pytest.raises(NotImplementedError, match="sliding window"):
        tl.attention(ta, tm.cfg, torch.zeros(1, 1, 64),
                     torch.zeros(1, 1, dtype=torch.long), window=W,
                     cache=cache, cache_pos=torch.zeros(1, dtype=torch.int32))


# ---------------------------------------------------------------------------
# The whole SMOKE stack
# ---------------------------------------------------------------------------
def test_plan_and_tree_match_reference(pair):
    cfg, jm, jp, tm, tp = pair
    assert tm._gemma_plan() == jm._gemma_plan() == (2, 2, 1)
    assert build_model(get_config(ARCH), device="meta")._gemma_plan() == \
        (5, 10, 2)
    got, want = tree.flatten(tp)[0], jax.tree.leaves(jp)
    assert [tuple(a.shape) for a in got] == [b.shape for b in want]
    drawn = tree.flatten(tm.init(torch.Generator().manual_seed(0)))[0]
    assert [tuple(a.shape) for a in drawn] == [b.shape for b in want]
    local = tm.init(torch.Generator().manual_seed(0))["super"]["local"]
    assert float(local["mlp"]["wo"].std()) == pytest.approx(
        cfg.d_ff ** -0.5, rel=0.1)
    c = tm.init_cache(2, 32)
    jc = jm.init_cache(2, 32)
    assert [tuple(a.shape) for a in tree.flatten(c)[0]] == \
        [b.shape for b in jax.tree.leaves(jc)]
    assert tm.pageable is False and tm.chunkable is True


def test_logits_match_reference(pair):
    cfg, jm, jp, tm, tp = pair
    tok = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 20))
    jh, _, _ = jm.forward(jp, jnp.asarray(tok, jnp.int32))
    with torch.no_grad():
        th, _, _ = tm.forward(tp, torch.from_numpy(tok))
    w = np.asarray(j_unembed(jp["embed"], cfg))
    np.testing.assert_allclose(th.numpy() @ w, np.asarray(jh) @ w, **TOL)


def test_loss_and_grads_match_reference(pair):
    cfg, jm, jp, tm, tp = pair
    tok = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 16))
    (jloss, _), jg = jax.value_and_grad(jm.loss, has_aux=True)(
        jp, {"tokens": jnp.asarray(tok, jnp.int32)})
    loss, met, grads = loss_and_grads(tm, tp,
                                      {"tokens": torch.from_numpy(tok)})
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    assert float(met["aux"]) == 0.0
    got = [x.detach().numpy() for x in tree.flatten(grads)[0]]
    want = [np.asarray(x) for x in jax.tree.leaves(jg)]
    assert [a.shape for a in got] == [b.shape for b in want]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **TOL)
    assert float(grads["super"]["global"]["attn"]["wq"].abs().max()) > 0


def _ring_hidden(pair, tok):
    """Final hidden states of a lockstep prefill of ``tok`` through the
    ring caches, in both packages, and the reference's cache-less
    forward (true sliding-window attention)."""
    _, jm, jp, tm, tp = pair
    T = tok.shape[1]
    jh, _, _ = jm.forward(jp, jnp.asarray(tok), caches=jm.init_cache(2, 64),
                          cache_pos=jnp.int32(0), start_pos=jnp.int32(0))
    with torch.no_grad():
        th, _, _ = tm.forward(tp, torch.from_numpy(tok),
                              caches=tm.init_cache(2, 64), cache_pos=0,
                              start_pos=0)
    free, _, _ = jm.forward(jp, jnp.asarray(tok))
    assert T == tok.shape[1]
    return th.numpy(), np.asarray(jh), np.asarray(free)


@pytest.mark.parametrize("T", [6, 8, 12, 24])
def test_ring_path_departs_from_sliding_window_past_w(pair, T):
    """Both packages' ring path agree; up to W tokens they equal the
    cache-less forward, past W they do not (the reference's ring of
    exactly W slots has overwritten keys its earlier queries need)."""
    tok = np.random.default_rng(T).integers(0, 256, (2, T)).astype(np.int32)
    port, refh, free = _ring_hidden(pair, tok)
    np.testing.assert_allclose(port, refh, **TOL)
    gap = np.abs(refh - free).max()
    if T <= W:
        assert gap <= 1e-5, gap
    else:
        assert gap > 1e-2, gap


# ---------------------------------------------------------------------------
# Serving under the four dense schedulers
# ---------------------------------------------------------------------------
SCHEDULERS = ("slot_chunked", "slot_fused", "slot", "wave")
WORK = [(5, 12), (20, 10), (13, 16), (3, 6), (27, 9), (9, 11)]
ENGINE = dict(max_batch=3, max_len=64, n_clients=1, intake_depth=16)


@pytest.fixture(scope="module")
def gemma3():
    return smoke_pair(ARCH, scale=3.0)


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
def served(gemma3):
    cfg, jm, jp, tm, tp = gemma3
    rng = np.random.default_rng(1)
    work = [(rng.integers(0, cfg.vocab_size, n), m) for n, m in WORK]
    out = {}
    for sched in SCHEDULERS:
        je = jengine.ServeEngine(jm, jp, scheduler=sched, **ENGINE)
        te = tengine.ServeEngine(tm, tp, scheduler=sched, device="cpu",
                                 **ENGINE)
        out[sched] = (je, _serve(je, work), te, _serve(te, work))
    return out


@pytest.mark.parametrize("sched", SCHEDULERS)
def test_serving_tokens_match_reference(served, sched):
    je, jseqs, te, tseqs = served[sched]
    assert tseqs == jseqs
    assert [len(s) for s in tseqs] == [m for _, m in WORK]
    assert te.chunk_tokens == je.chunk_tokens == 16 > W


@pytest.mark.parametrize("sched", SCHEDULERS)
def test_serving_counters_match_reference(served, sched):
    je, _, te, _ = served[sched]
    for key in COUNTERS:
        assert te.stats[key] == je.stats[key], key
    assert te.pool.kv_copy_bytes == je.pool.kv_copy_bytes
    assert te.dense_cache_bytes() == je.dense_cache_bytes()


def test_slot_paged_is_refused_as_in_reference(gemma3):
    _, jm, jp, tm, tp = gemma3
    with pytest.raises(ValueError) as want:
        jengine.ServeEngine(jm, jp, scheduler="slot_paged")
    with pytest.raises(ValueError) as got:
        tengine.ServeEngine(tm, tp, scheduler="slot_paged", device="cpu")
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# Engine repairs for a heterogeneous cache
# ---------------------------------------------------------------------------
def test_write_slot_caches_walks_the_tree(pair):
    """A B=1 prefilled gemma cache lands in row 1 of a batch cache whose
    batch axis is 2 for the local rings and 1 for the global ones and
    the tail, exactly as the reference's ``put``."""
    _, jm, jp, tm, tp = pair
    tok = np.random.default_rng(5).integers(0, 256, (1, 11)).astype(np.int32)
    _, jone = jm.prefill(jp, jnp.asarray(tok), 32)
    with torch.no_grad():
        _, one = tm.prefill(tp, torch.from_numpy(tok), 32)
    full = tm.init_cache(3, 32)
    jfull = jax.tree.map(lambda a: jnp.ones_like(a), jm.init_cache(3, 32))
    for t in tree.flatten(full)[0]:
        t.fill_(1.0)
    tengine._write_slot_caches(full, one, 1)
    want = jengine._write_slot_caches(jfull, jone, 1)
    for a, b in zip(tree.flatten(full)[0], jax.tree.leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    local = full["super"]["local"]["k"]
    assert float(local[:, :, 0].min()) == float(local[:, :, 2].max()) == 1.0


@pytest.mark.parametrize("arch", ["smollm-135m", "olmoe-1b-7b",
                                  "arctic-480b", ARCH])
@pytest.mark.parametrize("max_batch,max_len", [(4, 2048), (2, 6)])
def test_dense_cache_bytes_match_reference(arch, max_batch, max_len):
    """``init_cache``'s leaves summed, as the reference sums its abstract
    cache: gemma's 10 global rings of max_len and 52 local ones of
    min(W, max_len) at full width (2.44 GB at max_batch 4, max_len 2048
    in bf16), for the SMOKE configs too."""
    for get, jget in ((get_smoke_config, j_smoke), (get_config, None)):
        if jget is None and arch != ARCH:
            continue
        cfg = get(arch)
        model = build_model(cfg, device="meta" if jget is None else "cpu")
        eng = tengine.ServeEngine.__new__(tengine.ServeEngine)
        eng.model, eng.max_batch, eng.max_len = model, max_batch, max_len
        got = eng.dense_cache_bytes()
        if jget is None:
            size = min(cfg.sliding_window, max_len)
            per_ring = 2 * max_batch * 16 * 128 * 2
            assert got == per_ring * (52 * size + 10 * max_len)
            continue
        je = jengine.ServeEngine.__new__(jengine.ServeEngine)
        je.model = j_build(dataclasses.replace(jget(arch)))
        je.max_batch, je.max_len = max_batch, max_len
        assert got == je.dense_cache_bytes()
