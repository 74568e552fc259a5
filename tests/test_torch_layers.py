"""The port's layers against ``repro.models.layers`` on converted weights
and the same numpy-seeded inputs: rms_norm, rope, the SwiGLU mlp, and
attention without a cache and through the paged branch — a [B]
cache_pos, a write_mask with a padded tail, writes and reads that cross
page boundaries.  Every query's output matches to 2e-5, the padded tail's
and an idle row's included: each query sees the keys the reference lets
it see (at or before its position, below the row's written count), and a
row that has written nothing gets the reference's uniform average of its
gathered V.  The page writes land on exactly the same pool slots, with
values within 2e-5."""
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


def _layer0(jp, tp, key):
    return (jax.tree.map(lambda a: a[0], jp["layers"][key]),
            {k: v[0] for k, v in tp["layers"][key].items()})


def test_rms_norm_and_rope():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32)
    pos = rng.integers(0, 500, size=(2, 5))
    np.testing.assert_allclose(
        tl.rms_norm(torch.from_numpy(scale), torch.from_numpy(x)).numpy(),
        np.asarray(jl.rms_norm(jnp.asarray(scale), jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(
        tl.rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0).numpy(),
        np.asarray(jl.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)),
        **TOL)


def test_mlp(pair):
    _, _, jp, _, tp = pair
    jmlp, tmlp = _layer0(jp, tp, "mlp")
    x = np.random.default_rng(1).normal(size=(2, 3, 64)).astype(np.float32)
    np.testing.assert_allclose(tl.mlp(tmlp, torch.from_numpy(x)).numpy(),
                               np.asarray(jl.mlp(jmlp, jnp.asarray(x))),
                               **TOL)


def test_attention_without_cache(pair):
    cfg, _, jp, tm, tp = pair
    ja, ta = _layer0(jp, tp, "attn")
    x = np.random.default_rng(2).normal(size=(2, 6, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(6), (2, 6))
    jo, _ = jl.attention(ja, cfg, jnp.asarray(x), jnp.asarray(pos))
    to, _ = tl.attention(ta, tm.cfg, torch.from_numpy(x),
                         torch.from_numpy(np.array(pos)))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)


# (cache_pos, n_valid) per row, ps=4: row 0 crosses a page boundary mid
# chunk, row 1 has a padded tail, row 2 writes nothing (idle), row 3 is a
# one-token decode write at a page boundary.
PAGED = {
    "chunk_T4": (4, [(2, 4), (5, 2), (0, 0), (8, 1)]),
    "decode_T1": (1, [(3, 1), (7, 1), (0, 0), (4, 1)]),
    "chunk_T8": (8, [(4, 8), (0, 5), (9, 0), (1, 3)]),
}


@pytest.mark.parametrize("name", sorted(PAGED))
@pytest.mark.parametrize("li", [0, 1])
def test_paged_attention_branch(pair, name, li):
    cfg, _, jp, tm, tp = pair
    T, rows = PAGED[name]
    ja, ta = _layer0(jp, tp, "attn")
    B, n_pages, ps, L = len(rows), 20, 4, cfg.num_layers
    hkv, hd = cfg.num_kv_heads, cfg.head_dim_
    rng = np.random.default_rng(3)
    pk = rng.normal(size=(n_pages, ps, L, hkv, hd)).astype(np.float32)
    pv = rng.normal(size=(n_pages, ps, L, hkv, hd)).astype(np.float32)
    block = rng.permutation(n_pages)[:B * 4].reshape(B, 4).astype(np.int32)
    x = rng.normal(size=(B, T, 64)).astype(np.float32)
    cp = np.array([c for c, _ in rows], np.int32)
    nv = np.array([n for _, n in rows], np.int32)
    wm = np.arange(T)[None, :] < nv[:, None]
    pos = cp[:, None] + np.arange(T)[None, :]

    jo, jc = jl.attention(
        ja, cfg, jnp.asarray(x), jnp.asarray(pos),
        cache={"pages_k": jnp.asarray(pk), "pages_v": jnp.asarray(pv),
               "block": jnp.asarray(block), "layer": li},
        cache_pos=jnp.asarray(cp), write_mask=jnp.asarray(wm))
    sink = np.zeros((1,) + pk.shape[1:], np.float32)
    sk = torch.from_numpy(np.concatenate([pk, sink]))
    sv = torch.from_numpy(np.concatenate([pv, sink]))
    to, _ = tl.attention(
        ta, tm.cfg, torch.from_numpy(x), torch.from_numpy(pos),
        cache={"pages_k": sk, "pages_v": sv,
               "block": torch.from_numpy(block), "layer": li},
        cache_pos=torch.from_numpy(cp), write_mask=torch.from_numpy(wm))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    for before, jnew, tnew in ((pk, jc["pages_k"], sk), (pv, jc["pages_v"],
                                                         sv)):
        jnew, tnew = np.asarray(jnew), tnew.numpy()[:n_pages]
        np.testing.assert_array_equal(tnew != before, jnew != before)
        assert (tnew != before).sum() == int(nv.sum()) * hkv * hd
        np.testing.assert_allclose(tnew, jnew, **TOL)


# (cache_pos, n_valid) per row: an idle row at cp 0 (writes nothing, sees
# no key: the reference's uniform average of its gathered V), a dead row
# at cp > 0 (sees only the keys it wrote before), a padded chunk tail
# (its padded queries see the written keys only) and a live row.
UNWRITTEN = {1: [(0, 0), (6, 0), (3, 1), (9, 1)],
             4: [(0, 0), (6, 0), (3, 2), (2, 4)]}


@pytest.mark.parametrize("T", sorted(UNWRITTEN))
@pytest.mark.parametrize("branch", ["paged", "dense_ring"])
def test_rows_that_write_nothing_match_reference(pair, branch, T):
    """The masked-query repair: every query of an idle row, a dead row and
    a padded tail equals the reference's attention output, through the
    paged branch and the dense ring's [B] branch (identity pages)."""
    cfg, _, jp, tm, tp = pair
    ja, ta = _layer0(jp, tp, "attn")
    rows = UNWRITTEN[T]
    B, ps, P, L = len(rows), 4, 4, cfg.num_layers
    hkv, hd = cfg.num_kv_heads, cfg.head_dim_
    rng = np.random.default_rng(7 + T)
    x = rng.normal(size=(B, T, 64)).astype(np.float32)
    cp = np.array([c for c, _ in rows], np.int32)
    nv = np.array([n for _, n in rows], np.int32)
    wm = np.arange(T)[None, :] < nv[:, None]
    pos = cp[:, None] + np.arange(T)[None, :]
    if branch == "paged":
        n_pages = 3 * B * P
        pk = rng.normal(size=(n_pages, ps, L, hkv, hd)).astype(np.float32)
        pv = rng.normal(size=(n_pages, ps, L, hkv, hd)).astype(np.float32)
        block = rng.permutation(n_pages)[:B * P].reshape(B, P).astype(
            np.int32)
        block[0] = 0                         # an idle slot's table
        jcache = {"pages_k": jnp.asarray(pk), "pages_v": jnp.asarray(pv),
                  "block": jnp.asarray(block), "layer": 1}
        sink = np.zeros((1,) + pk.shape[1:], np.float32)
        tcache = {"pages_k": torch.from_numpy(np.concatenate([pk, sink])),
                  "pages_v": torch.from_numpy(np.concatenate([pv, sink])),
                  "block": torch.from_numpy(block), "layer": 1}
    else:
        size = ps * P
        shape = (B, size, hkv, hd)
        rk = rng.normal(size=shape).astype(np.float32)
        rv = rng.normal(size=shape).astype(np.float32)
        jcache = {"k": jnp.asarray(rk), "v": jnp.asarray(rv)}
        tcache = {"k": torch.from_numpy(rk.copy()),
                  "v": torch.from_numpy(rv.copy()),
                  "block": tm._ring_block(B, size)}
    jo, _ = jl.attention(ja, cfg, jnp.asarray(x), jnp.asarray(pos),
                         cache=jcache, cache_pos=jnp.asarray(cp),
                         write_mask=jnp.asarray(wm))
    to, _ = tl.attention(ta, tm.cfg, torch.from_numpy(x),
                         torch.from_numpy(pos), cache=tcache,
                         cache_pos=torch.from_numpy(cp),
                         write_mask=torch.from_numpy(wm))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    assert np.abs(to.numpy()[0]).max() > 0       # the idle row is filled


def test_written_lens_is_the_written_count():
    cp = torch.tensor([0, 6, 3], dtype=torch.int32)
    wm = torch.tensor([[False, False], [False, False], [True, False]])
    assert tl.written_lens(cp, wm).tolist() == [0, 6, 4]
    assert tl.written_lens(cp, wm).dtype == torch.int32
    assert tl.written_lens(cp, None) is None
