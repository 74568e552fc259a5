"""The port's dense-ring cache against the JAX package's, on converted
weights and the same numpy-seeded inputs at float32.

``layers.attention`` with a dense ring: a scalar ``cache_pos`` (prefill
and lockstep decode: the flash path) and a [B] one (per-row decode and
chunked admission: the paged kernel over identity pages), a write_mask
with a padded tail, and a padded final chunk whose slots wrap past the
ring's end.  Every query's output matches to 2e-5, those that write
nothing included (an idle row gets the reference's uniform average of
the ring's V); the rings match to 2e-5 everywhere, so masked slots kept
their old values.  Then ``Model.prefill``, ``decode_loop`` and
``prefill_chunk_into``/``chunked_block`` over a dense cache: greedy
tokens identical, caches equal."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import smoke_pair  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(scope="module")
def pair():
    return smoke_pair()


def _layer0(jp, tp):
    return (jax.tree.map(lambda a: a[0], jp["layers"]["attn"]),
            {k: v[0] for k, v in tp["layers"]["attn"].items()})


def _ring(cfg, B, size, seed):
    rng = np.random.default_rng(seed)
    shape = (B, size, cfg.num_kv_heads, cfg.head_dim_)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


def _run_both(pair, x, pos, ring, cache_pos, write_mask=None):
    cfg, _, jp, tm, tp = pair
    ja, ta = _layer0(jp, tp)
    jcp = (jnp.int32(cache_pos) if isinstance(cache_pos, int)
           else jnp.asarray(cache_pos, jnp.int32))
    jo, jc = jl.attention(
        ja, cfg, jnp.asarray(x), jnp.asarray(pos),
        cache={"k": jnp.asarray(ring[0]), "v": jnp.asarray(ring[1])},
        cache_pos=jcp,
        write_mask=None if write_mask is None else jnp.asarray(write_mask))
    tcache = {"k": torch.from_numpy(ring[0].copy()),
              "v": torch.from_numpy(ring[1].copy())}
    tcp = cache_pos
    if not isinstance(cache_pos, int):
        tcp = torch.tensor(cache_pos, dtype=torch.int32)
        tcache["block"] = tm._ring_block(*ring[0].shape[:2])
    to, _ = tl.attention(
        ta, tm.cfg, torch.from_numpy(x), torch.from_numpy(np.array(pos)),
        cache=tcache, cache_pos=tcp,
        write_mask=None if write_mask is None
        else torch.from_numpy(write_mask))
    for n in ("k", "v"):
        np.testing.assert_allclose(tcache[n].numpy(), np.asarray(jc[n]),
                                   **TOL)
    return to.numpy(), np.asarray(jo)


@pytest.mark.parametrize("T,cp", [(6, 0), (1, 5), (3, 13)])
def test_attention_scalar_cache_pos(pair, T, cp):
    """Lockstep writes into the same slots of every row, then the flash
    read over the written prefix; every query is read by the caller."""
    cfg = pair[0]
    B, size = 2, 16
    x = np.random.default_rng(T).normal(size=(B, T, 64)).astype(np.float32)
    pos = np.broadcast_to(cp + np.arange(T), (B, T))
    to, jo = _run_both(pair, x, pos, _ring(cfg, B, size, 10 + T), cp)
    np.testing.assert_allclose(to, jo, **TOL)


# (cache_pos, n_valid) per row in a size-16 ring: a mid-ring chunk, a
# padded tail, an idle row, and a final chunk whose padded slots wrap
# past the ring's end onto slots 0..1 (which must keep their values).
VECTOR = {
    "chunk_T4": (4, [(2, 4), (9, 2), (0, 0), (14, 2)]),
    "decode_T1": (1, [(3, 1), (15, 1), (0, 1), (7, 1)]),
    "chunk_T8_wrap": (8, [(0, 8), (12, 4), (5, 0), (10, 6)]),
}


@pytest.mark.parametrize("name,masked", [(n, True) for n in sorted(VECTOR)]
                         + [("decode_T1", False)])
def test_attention_vector_cache_pos(pair, name, masked):
    """Per-row slots through the paged kernel over identity pages; the
    unmasked case is the dense decode loop's write (no write_mask)."""
    cfg = pair[0]
    T, rows = VECTOR[name]
    B, size = len(rows), 16
    cp = [c for c, _ in rows]
    nval = np.array([n for _, n in rows])
    wm = np.arange(T)[None, :] < nval[:, None]
    x = np.random.default_rng(len(name)).normal(
        size=(B, T, 64)).astype(np.float32)
    pos = np.array(cp)[:, None] + np.arange(T)[None, :]
    to, jo = _run_both(pair, x, pos, _ring(cfg, B, size, 20), cp,
                       wm if masked else None)
    np.testing.assert_allclose(to, jo, **TOL)


def test_sliding_window_ring_is_refused(pair):
    """Named for the refusal it pinned before the ring bound: a windowed
    ring (the smollm layer under window 8 over an 8-slot ring) now reads
    with wrap-around as the reference does, lockstep past the ring and
    per row with a chunk longer than the ring."""
    cfg, _, jp, tm, tp = pair
    ja, ta = _layer0(jp, tp)
    for T, cp, wm in ((12, 0, None), (1, 9, None),
                      (10, [0, 6], np.arange(10)[None] < np.array([[10],
                                                                   [4]]))):
        B = 2
        rng = np.random.default_rng(T)
        x = rng.normal(size=(B, T, 64)).astype(np.float32)
        pos = (np.asarray(cp).reshape(-1, 1) + np.arange(T)).astype(
            np.int32) * np.ones((B, 1), np.int32)
        rk, rv = _ring(cfg, B, 8, T)
        jcp = (jnp.int32(cp) if isinstance(cp, int)
               else jnp.asarray(cp, jnp.int32))
        jo, jc = jl.attention(
            ja, cfg, jnp.asarray(x), jnp.asarray(pos), window=8,
            cache={"k": jnp.asarray(rk), "v": jnp.asarray(rv)},
            cache_pos=jcp, write_mask=None if wm is None
            else jnp.asarray(wm))
        cache = {"k": torch.from_numpy(rk.copy()),
                 "v": torch.from_numpy(rv.copy()),
                 "block": tm._ring_block(B, 8)}
        to, _ = tl.attention(
            ta, tm.cfg, torch.from_numpy(x), torch.from_numpy(pos),
            window=8, cache=cache,
            cache_pos=cp if isinstance(cp, int)
            else torch.tensor(cp, dtype=torch.int32),
            write_mask=None if wm is None else torch.from_numpy(wm))
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
        for n in ("k", "v"):
            np.testing.assert_allclose(cache[n].numpy(), np.asarray(jc[n]),
                                       **TOL)


def _t2n(c):
    return {n: c[n].numpy() for n in ("k", "v")}


def _j2n(c):
    return {n: np.asarray(c[n]) for n in ("k", "v")}


def _same_cache(tc, jc):
    for n in ("k", "v"):
        np.testing.assert_allclose(tc[n], jc[n], **TOL)


def test_prefill_then_decode_loop(pair):
    """Model.prefill (B=2 left-padded prompts, the wave shape) into a
    fresh dense cache, then a 5-step fused decode_loop with per-row
    budgets and an EOS: identical tokens, equal caches."""
    cfg, jm, jp, tm, tp = pair
    max_len = 24
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    toks[1, :3] = 0                                  # left padding
    jtok, jc = jax.jit(lambda p, t: jm.prefill(p, t, max_len))(
        jp, jnp.asarray(toks))
    with torch.no_grad():
        ttok, tc = tm.prefill(tp, torch.from_numpy(toks), max_len)
    assert ttok.tolist() == np.asarray(jtok).tolist()
    _same_cache(_t2n(tc), _j2n(jc))
    cur = np.asarray(jtok).astype(np.int32)
    pos, rem = np.array([8, 8], np.int32), np.array([5, 4], np.int32)
    jloop = jax.jit(jm.decode_loop, static_argnames=("k", "max_len"))
    # Row 1's EOS is its second greedy token, so it dies mid-block.
    free, _ = jloop(jp, jc, *map(jnp.asarray, (cur, pos, rem,
                                                np.array([-1, -1]))),
                    k=5, max_len=max_len)
    eos = np.array([-1, int(np.asarray(free)[1, 1])], np.int32)
    args = (cur, pos, rem, eos)
    jblk, jc = jloop(jp, jc, *map(jnp.asarray, args), k=5, max_len=max_len)
    with torch.no_grad():
        tblk, tc = tm.decode_loop(tp, tc, *map(torch.from_numpy, args), k=5,
                                  max_len=max_len)
    assert tblk.tolist() == np.asarray(jblk).tolist()
    _same_cache(_t2n(tc), _j2n(jc))


def test_lockstep_decode_step(pair):
    """The wave scheduler's decode: a Python-int position shared by the
    batch (flash over the ring prefix), three steps."""
    cfg, jm, jp, tm, tp = pair
    max_len = 16
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (3, 6)).astype(np.int32)
    jtok, jc = jm.prefill(jp, jnp.asarray(toks), max_len)
    with torch.no_grad():
        ttok, tc = tm.prefill(tp, torch.from_numpy(toks), max_len)
    jstep = jax.jit(jm.decode_step)
    for step in range(3):
        assert ttok.tolist() == np.asarray(jtok).tolist()
        jtok, jc = jstep(jp, jc, jtok[:, None], jnp.int32(6 + step))
        with torch.no_grad():
            ttok, tc = tm.decode_step(tp, tc, ttok[:, None], 6 + step)
    assert ttok.tolist() == np.asarray(jtok).tolist()
    _same_cache(_t2n(tc), _j2n(jc))


def test_chunked_admission_into_dense_cache(pair):
    """prefill_chunk_into + chunked_block over a [2, 22] dense ring, as
    the slot_chunked engine drives them: row 0 streams an 18-token prompt
    in 8-token chunks (its final chunk's padded slots wrap onto slots
    0..1) and joins decode; row 1 decodes meanwhile.  Identical tokens at
    every dispatch, equal caches at the end."""
    cfg, jm, jp, tm, tp = pair
    max_len, C, k = 22, 8, 3
    rng = np.random.default_rng(5)
    p0 = rng.integers(0, cfg.vocab_size, 18).astype(np.int32)
    p1 = rng.integers(0, cfg.vocab_size, 5).astype(np.int32)
    jc = jm.init_cache(2, max_len)
    tc = tm.init_cache(2, max_len)
    i32 = lambda *a: np.array(a, np.int32)  # noqa: E731

    def chunk(*rows):
        out = np.zeros((2, C), np.int32)
        for i, r in enumerate(rows):
            out[i, :len(r)] = r
        return out

    jfirst = jax.jit(jm.prefill_chunk_into)
    jblock = jax.jit(jm.chunked_block, static_argnames=("k", "max_len"))
    # 1) chunk-only dispatch: row 0's first chunk, row 1's whole prompt.
    a = (chunk(p0[:8], p1), i32(0, 0), i32(8, 5))
    jt, jc = jfirst(jp, jc, *map(jnp.asarray, a))
    with torch.no_grad():
        tt, tc = tm.prefill_chunk_into(tp, tc, *map(torch.from_numpy, a))
    assert tt.tolist() == np.asarray(jt).tolist()
    cur1 = int(np.asarray(jt)[1])
    # 2) row 0's middle chunk rides row 1's K-step decode block.
    steps = [(chunk(p0[8:16]), i32(8, 0), i32(8, 0), i32(0, cur1),
              i32(16, 5), i32(0, 6), i32(-1, -1))]
    jt, jb, jc = jblock(jp, jc, *map(jnp.asarray, steps[0]), k=k,
                        max_len=max_len)
    with torch.no_grad():
        tt, tb, tc = tm.chunked_block(tp, tc, *map(torch.from_numpy,
                                                   steps[0]),
                                      k=k, max_len=max_len)
    assert tb.tolist() == np.asarray(jb).tolist()
    assert tt[0].item() == int(np.asarray(jt)[0])      # row 1 wrote nothing
    last1 = int(np.asarray(jb)[1, -1])
    # 3) row 0's final chunk (2 valid tokens at 16..17, padding wraps to
    #    slots 0..1) joins the decode block; row 1 continues.
    fin = (chunk(p0[16:]), i32(16, 0), i32(2, 0), i32(0, last1),
           i32(18, 8), i32(3, 3), i32(-1, -1))
    jt, jb, jc = jblock(jp, jc, *map(jnp.asarray, fin), k=k,
                        max_len=max_len)
    with torch.no_grad():
        tt, tb, tc = tm.chunked_block(tp, tc, *map(torch.from_numpy, fin),
                                      k=k, max_len=max_len)
    assert tt[0].item() == int(np.asarray(jt)[0])
    assert tb.tolist() == np.asarray(jb).tolist()
    _same_cache(_t2n(tc), _j2n(jc))
