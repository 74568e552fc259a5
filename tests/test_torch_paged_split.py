"""The split-KV form of the port's paged attention on the CPU:
``ref.paged_attention_split_ref`` — each run of ``split_keys`` keys'
(max, sum, accumulator), merged in split order, as the kernel's split
route computes it — against the JAX package's oracle
``repro.kernels.ref.paged_attention_ref`` on the same numpy-seeded
inputs, at several split sizes: splits wholly past a row's length, a
zero-length row, rows shorter than one split, T=1 and T=8, page sizes
8/16/64, GQA 9:3, 8:1 and 6:2, softcap.  Tolerance 2e-5 abs/rel (the
reference's own; the split form sums in another order).  Also the split
plan (a function of one row's static shapes, the same for a row alone
and in a batch, covering the row's keys) and the route the wrapper picks
for the card, both plain Python."""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import paged_attention as pa_mod  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

TOL = dict(atol=2e-5, rtol=2e-5)


def _setup(seed, B, T, H, Hkv, hd, n_pages, ps, P, lens):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, T, H, hd)).astype(np.float32)
    kp = rng.normal(size=(n_pages, ps, Hkv, hd)).astype(np.float32)
    vp = rng.normal(size=(n_pages, ps, Hkv, hd)).astype(np.float32)
    block = rng.permutation(n_pages)[:B * P].reshape(B, P).astype(np.int32)
    return q, kp, vp, block, np.asarray(lens, np.int32)


def _split_vs_jax(inputs, split_keys, softcap=0.0):
    q, kp, vp, block, lens = inputs
    got = tref.paged_attention_split_ref(
        *(torch.from_numpy(a) for a in inputs), split_keys=split_keys,
        softcap=softcap).numpy()
    want = np.asarray(jref.paged_attention_ref(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(block),
        jnp.asarray(lens), softcap=softcap))
    np.testing.assert_allclose(got, want, **TOL)
    return got


CASES = {
    # B=8 at ps=16 over 8 pages (128 positions): a zero-length row, rows
    # shorter than one split, rows whose later splits are all past lens.
    "decode_b8_ps16": dict(seed=0, B=8, T=1, H=9, Hkv=3, hd=16, n_pages=96,
                           ps=16, P=8, lens=[0, 1, 5, 16, 17, 64, 100, 128]),
    "decode_gqa_8_1_ps8": dict(seed=1, B=3, T=1, H=8, Hkv=1, hd=32,
                               n_pages=40, ps=8, P=12,
                               lens=[3, 40, 96]),
    "decode_gqa_6_2_ps64": dict(seed=2, B=4, T=1, H=6, Hkv=2, hd=16,
                                n_pages=16, ps=64, P=4,
                                lens=[65, 300, 0, 256]),
    "chunk_t8_gqa_9_3_ps16": dict(seed=3, B=3, T=8, H=9, Hkv=3, hd=16,
                                  n_pages=40, ps=16, P=8,
                                  lens=[8, 30, 128]),
    "chunk_t8_lens_below_t": dict(seed=4, B=2, T=8, H=4, Hkv=2, hd=16,
                                  n_pages=16, ps=8, P=6, lens=[3, 0]),
    "past_the_table": dict(seed=5, B=2, T=8, H=4, Hkv=2, hd=16, n_pages=16,
                           ps=4, P=3, lens=[14, 5]),
}


@pytest.mark.parametrize("split_keys", [8, 16, 64, 128])
@pytest.mark.parametrize("name", sorted(CASES))
def test_split_ref_matches_jax(name, split_keys):
    _split_vs_jax(_setup(**CASES[name]), split_keys)


def test_split_ref_softcap_matches_jax():
    _split_vs_jax(_setup(**CASES["decode_b8_ps16"]), 32, softcap=5.0)


def test_split_ref_zero_rows_are_exact_zeros():
    """A row of length 0 and a row whose queries all precede position 0
    (lens < T) sees no key in any split: exact zeros, no NaN."""
    out = _split_vs_jax(_setup(**CASES["chunk_t8_lens_below_t"]), 16)
    assert not np.isnan(out).any()
    assert np.count_nonzero(out[1]) == 0              # lens 0
    assert np.count_nonzero(out[0, :5]) == 0          # q_pos < 0


def test_split_ref_equals_plain_version():
    """The split form and the dense plain version agree on the port's own
    plain path (f32, same inputs)."""
    inputs = [torch.from_numpy(a) for a in _setup(**CASES["decode_b8_ps16"])]
    a = tref.paged_attention_split_ref(*inputs, split_keys=64)
    b = tref.paged_attention_ref(*inputs)
    torch.testing.assert_close(a, b, **TOL)


# ---------------------------------------------------------------------------
# kv_lens: the written-key bound of both plain versions
# ---------------------------------------------------------------------------
# (case, kv_lens per row): rows with kv_lens 0 (no key: zeros), below
# lens (a dead row, a padded tail) and equal to lens.
KV_LENS = {
    "decode_b8_ps16": [0, 0, 3, 16, 9, 64, 50, 128],
    "chunk_t8_gqa_9_3_ps16": [5, 0, 125],
    "past_the_table": [10, 5],
}


def _per_query_jax(inputs, kv_lens, softcap=0.0):
    """The JAX oracle one query at a time: query t of row b, alone (T=1),
    at a length of min(lens - T + t + 1, kv_lens): it sees exactly the
    keys below that."""
    q, kp, vp, block, lens = inputs
    T = q.shape[1]
    outs = []
    for t in range(T):
        lt = np.minimum(lens - T + t + 1, kv_lens).clip(min=0)
        outs.append(np.asarray(jref.paged_attention_ref(
            jnp.asarray(q[:, t:t + 1]), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(block), jnp.asarray(lt.astype(np.int32)),
            softcap=softcap)))
    return np.concatenate(outs, axis=1)


@pytest.mark.parametrize("name", sorted(KV_LENS))
def test_kv_lens_bounds_both_plain_versions(name):
    inputs = _setup(**CASES[name])
    kv = np.asarray(KV_LENS[name], np.int32)
    want = _per_query_jax(inputs, kv, softcap=5.0)
    targs = [torch.from_numpy(a) for a in inputs]
    kv_t = torch.from_numpy(kv)
    got = tref.paged_attention_ref(*targs, softcap=5.0, kv_lens=kv_t)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    for split_keys in (16, 64):
        got = tref.paged_attention_split_ref(*targs, split_keys=split_keys,
                                             softcap=5.0, kv_lens=kv_t)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert np.count_nonzero(got.numpy()[kv == 0]) == 0


def test_kv_lens_at_or_past_lens_changes_nothing():
    inputs = _setup(**CASES["decode_b8_ps16"])
    targs = [torch.from_numpy(a) for a in inputs]
    kv = torch.from_numpy(inputs[4] + np.arange(8, dtype=np.int32) % 2)
    torch.testing.assert_close(
        tref.paged_attention_ref(*targs, kv_lens=kv),
        tref.paged_attention_ref(*targs), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The split plan and the route
# ---------------------------------------------------------------------------
def test_split_plan_takes_static_shapes_only():
    """The plan is a function of one row's static shapes (T, the table's
    positions, the ring bound, the route): no batch, no kv heads, no
    lens, so the decode loop needs no device-to-host read to launch."""
    assert list(inspect.signature(pa_mod.split_plan).parameters) == [
        "T", "positions", "ring", "window", "chunk"]
    assert pa_mod.split_plan(1, 1024) == pa_mod.split_plan(1, 1024)


@pytest.mark.parametrize("T,positions,ring,window,chunk,want", [
    (1, 1024, 0, 0, False, (128, 8)),      # slot_paged decode: P=64, ps=16
    (1, 1024, 0, 0, False, (128, 8)),      # slot_fused: the ring as 64-token
    (1, 32, 0, 0, False, (64, 1)),         # 32 positions: one run
    (1, 32768, 0, 0, False, (4096, 8)),    # 2048 pages of 16
    (64, 1024, 0, 0, True, (512, 2)),      # slot_paged chunk
    (1, 1024, 1024, 1024, False, (128, 8)),  # gemma's ring, decode
    (64, 1024, 1024, 1024, True, (512, 2)),  # gemma's ring, chunk
    (1, 4096, 1024, 200, False, (64, 4)),  # a window inside the ring
])
def test_split_plan_main_shapes(T, positions, ring, window, chunk, want):
    assert pa_mod.split_plan(T, positions, ring, window, chunk) == want


def _walk_keys(T, positions, ring, window):
    """The most keys a row's walk holds: the table's or the ring's, and
    with a window no more than window + T - 1."""
    keys = ring or positions
    return min(keys, window + T - 1) if window else keys


@pytest.mark.parametrize("T,positions,ring,window,chunk", [
    (1, 4, 0, 0, False), (1, 1024, 0, 0, False), (4, 1024, 0, 0, False),
    (1, 896, 0, 0, False), (64, 8208, 0, 0, True), (1, 0, 0, 0, False),
    (64, 1024, 1000, 0, True), (1, 2048, 1024, 300, False),
    (128, 32768, 0, 0, True),
])
def test_split_plan_covers_the_table_in_whole_tiles(T, positions, ring,
                                                     window, chunk):
    keys, n_split = pa_mod.split_plan(T, positions, ring, window, chunk)
    walk = _walk_keys(T, positions, ring, window)
    assert n_split >= 1 and keys % pa_mod.SPLIT_TILE == 0
    assert n_split * keys >= walk
    assert (n_split - 1) * keys < max(1, walk)    # no run wholly past it
    assert n_split <= (pa_mod.CHUNK_SPLITS if chunk else 64)


@pytest.mark.parametrize("T,lens,kv_lens,ring,window", [
    (1, [0, 5, 63, 64, 65, 300, 545, 1024], None, 0, 0),
    (64, [64, 300, 40, 1100, 1024, 128, 900, 64], None, 0, 0),
    (1, [700, 1024, 1500, 2047, 1, 64, 1025, 1900],
     [700, 1024, 1500, 2047, 0, 64, 1025, 1900], 1024, 1024),
    (64, [700, 1024, 1500, 2047, 64, 100, 1088, 2000],
     [690, 1024, 1500, 2000, 64, 100, 1088, 1999], 1024, 200),
])
def test_split_plan_of_a_row_alone_and_in_a_batch(T, lens, kv_lens, ring,
                                                  window):
    """The plan a row gets is the same alone (B=1) and in a batch of 8,
    and its runs cover the row's whole walk: from its key_lo (or its
    first query's window edge) to its key end."""
    def inputs(B):
        q = torch.zeros((B, T, 9, 64), dtype=torch.bfloat16)
        pages = torch.zeros((8, 64, 3, 64), dtype=torch.bfloat16)
        return q, pages, pages, torch.zeros((B, 16), dtype=torch.int32)
    batch = pa_mod.plan(*inputs(8), ring=ring, window=window)
    assert batch == pa_mod.plan(*inputs(1), ring=ring, window=window)
    assert batch[0] == ("split" if T == 1 else "wgmma")
    keys, n_split = batch[1]
    for b, n in enumerate(lens):
        end = min(n, 1024) if kv_lens is None else kv_lens[b]
        lo = max(0, end - ring) if ring else 0
        if window:
            lo = max(lo, n - T - window + 1)
        hi = min(end, n)
        assert n_split * keys >= hi - lo, (b, n)


def _route(dtype, B, T, H, Hkv, hd, ps=16, view=False):
    q = torch.zeros((B, T, H, hd), dtype=dtype)
    if view:                                   # a pool's per-layer view
        pool = torch.zeros((8, ps, 3, Hkv, hd), dtype=dtype)
        k = v = pool[:, :, 1]
    else:
        k = v = torch.zeros((8, ps, Hkv, hd), dtype=dtype)
    return pa_mod.route(q, k, v)


def test_route_by_shape():
    bf16, f32 = torch.bfloat16, torch.float32
    assert _route(bf16, 8, 1, 9, 3, 64, view=True) == "split"
    assert _route(f32, 8, 1, 9, 3, 64) == "simt"             # no TF32
    assert _route(bf16, 2, 5, 9, 3, 64) == "split"           # 15 rows
    assert _route(bf16, 8, 64, 9, 3, 64, view=True) == "wgmma"
    assert _route(bf16, 2, 6, 9, 3, 64) == "wgmma"        # 18 rows
    assert _route(f32, 8, 64, 9, 3, 64) == "simt"
    assert _route(bf16, 2, 1, 4, 2, 80) == "split"           # head_dim 80
    assert _route(bf16, 2, 64, 32, 32, 80) == "wgmma"     # zamba's
    assert _route(bf16, 2, 1, 4, 2, 48) == "simt"            # head_dim 48
    assert _route(bf16, 2, 64, 4, 2, 12) == "simt"


def test_route_needs_aligned_rows():
    q = torch.zeros((2, 1, 4, 16), dtype=torch.bfloat16)
    kv = torch.zeros((8, 4, 2, 17), dtype=torch.bfloat16)[..., 1:]
    assert pa_mod.route(q, kv, kv) == "simt"
