"""The split-KV form of the port's flash forward on the CPU:
``ref.flash_attention_split_ref`` — each run of ``split_keys`` keys'
(max, sum, accumulator), merged in split order, as the forward's split
route computes it — against the JAX package's oracle
``repro.kernels.ref.flash_attention_ref`` and, where its divisibility
allows, the Pallas ``flash_attention`` in interpret mode, on the same
numpy-seeded inputs: T=1 and small T; g of 1, 3, 4 and 16; head_dim 16,
64, 80 and 128; S shorter than one split and ragged past it; a window
that moves the first split and leaves whole splits empty for a row;
rows that see no key (exact zeros, lse -1e30, as the Pallas kernel's
``l == 0`` step gives); softcap; the log-sum-exp.  Tolerance 2e-5
abs/rel in float32 (the reference's own; the split form sums in another
order).  Also :func:`forward_route` and :func:`split_plan`, the plain
Python that picks the card's route and cuts the keys."""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jflash  # noqa: E402
from repro_torch.kernels import flash_attention as fa_mod  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

TOL = dict(atol=2e-5, rtol=2e-5)

# name: (B, T, S, H, Hkv, hd, kwargs, split_keys, Pallas (block_q,
# block_k) or None where S or T does not divide).
CASES = {
    # The wave's decode: g 3 over a ring of 513 (ragged last split).
    "decode_g3_hd64_ragged": (3, 1, 513, 9, 3, 64, {}, 128, None),
    # A cross read: g 4 at head_dim 128, non-causal, 3 splits.
    "cross_g4_hd128": (2, 1, 384, 8, 2, 128, dict(causal=False), 128,
                       (1, 128)),
    # S shorter than one split.
    "decode_g1_short": (2, 1, 50, 6, 6, 64, {}, 128, (1, 50)),
    # g 16 (16 rows: the whole tile) at head_dim 80.
    "decode_g16_hd80": (1, 1, 260, 16, 1, 80, {}, 128, (1, 130)),
    # A window at T=1: the first split starts at the window's edge.
    "decode_window": (2, 1, 1024, 4, 4, 64, dict(window=256), 128,
                      (1, 128)),
    # Small T with GQA: 4 tokens x 3 heads = 12 rows, causal per token.
    "small_t_g3": (2, 4, 70, 9, 3, 16, {}, 16, (4, 14)),
    # Softcap with g 4, head_dim 80.
    "softcap_g4_hd80": (2, 1, 400, 8, 2, 80, dict(softcap=30.0), 128,
                        (1, 100)),
    # A short window over small T and splits of 8: rows whose whole
    # splits see nothing.
    "window_empty_splits": (1, 8, 300, 4, 2, 64, dict(window=5), 8,
                            (8, 100)),
}


def _inputs(seed, B, T, S, H, Hkv, hd):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, T, H, hd)).astype(np.float32),
            rng.normal(size=(B, S, Hkv, hd)).astype(np.float32),
            rng.normal(size=(B, S, Hkv, hd)).astype(np.float32))


def _jax_lse(q, k, causal=True, window=0, softcap=0.0):
    """Each row's natural log-sum-exp of its masked scores, in jnp (the
    scores of ``repro.kernels.ref.flash_attention_ref``), [B, H, T]."""
    B, T, H, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    qg = jnp.asarray(q).reshape(B, T, Hkv, H // Hkv, hd)
    s = jnp.einsum("btkgh,bskh->bkgts", qg, jnp.asarray(k)) * hd ** -0.5
    if softcap:
        s = jnp.tanh(s / softcap) * softcap
    q_pos = jnp.arange(T)[:, None] + (S - T)
    kv_pos = jnp.arange(S)[None, :]
    mask = jnp.ones((T, S), bool)
    if causal:
        mask &= kv_pos <= q_pos
    if window:
        mask &= kv_pos > q_pos - window
    s = jnp.where(mask, s, -jnp.inf)
    return np.asarray(jax.nn.logsumexp(s, axis=-1)).reshape(B, H, T)


def _split(arrays, split_keys, kw):
    got, lse = tref.flash_attention_split_ref(
        *(torch.from_numpy(a) for a in arrays), split_keys=split_keys, **kw)
    assert got.dtype == torch.float32 and lse.dtype == torch.float32
    return got.numpy(), lse.numpy()


@pytest.mark.parametrize("name", sorted(CASES))
def test_split_ref_matches_jax(name):
    B, T, S, H, Hkv, hd, kw, split_keys, _ = CASES[name]
    arrays = _inputs(len(name), B, T, S, H, Hkv, hd)
    got, lse = _split(arrays, split_keys, kw)
    want = np.asarray(jref.flash_attention_ref(*map(jnp.asarray, arrays),
                                               **kw))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(lse, _jax_lse(arrays[0], arrays[1], **kw),
                               **TOL)


@pytest.mark.parametrize("name", sorted(n for n, c in CASES.items() if c[-1]))
def test_split_ref_matches_pallas_interpret(name):
    B, T, S, H, Hkv, hd, kw, split_keys, (bq, bk) = CASES[name]
    arrays = _inputs(len(name) + 1, B, T, S, H, Hkv, hd)
    got, _ = _split(arrays, split_keys, kw)
    want = np.asarray(jflash(*map(jnp.asarray, arrays), block_q=bq,
                             block_k=bk, interpret=True, **kw))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("split_keys", [8, 64, 128, 256])
def test_split_ref_any_split_size(split_keys):
    """The merged result does not depend on where the keys are cut (to
    f32 rounding): splits of 8 to 256 keys over a ragged S of 513."""
    B, T, S, H, Hkv, hd, kw, _, _ = CASES["decode_g3_hd64_ragged"]
    arrays = _inputs(3, B, T, S, H, Hkv, hd)
    got, _ = _split(arrays, split_keys, kw)
    want = np.asarray(jref.flash_attention_ref(*map(jnp.asarray, arrays)))
    np.testing.assert_allclose(got, want, **TOL)


def test_split_ref_rows_without_keys():
    """Causal with S < T: the first T - S queries see no key and get
    exact zeros and lse -1e30, as the Pallas kernel gives (its ``l == 0``
    step; the jnp reference gives them the mean of v); the rest match
    both."""
    B, T, S, H, Hkv, hd = 1, 8, 4, 4, 2, 16
    arrays = _inputs(12, B, T, S, H, Hkv, hd)
    got, lse = _split(arrays, 2, {})
    assert not np.isnan(got).any()
    assert np.count_nonzero(got[:, :T - S]) == 0
    assert (lse[:, :, :T - S] == -1e30).all()
    pallas = np.asarray(jflash(*map(jnp.asarray, arrays), block_q=8,
                               block_k=4, interpret=True))
    np.testing.assert_allclose(got, pallas, **TOL)
    want = np.asarray(jref.flash_attention_ref(*map(jnp.asarray, arrays)))
    np.testing.assert_allclose(got[:, T - S:], want[:, T - S:], **TOL)
    np.testing.assert_allclose(lse[:, :, T - S:],
                               _jax_lse(arrays[0], arrays[1])[:, :, T - S:],
                               **TOL)


def test_split_ref_equals_the_dense_plain_version():
    """The split form and the dense plain version (out and lse) agree on
    the port's own plain path, in f32 and in bf16 (to its rounding)."""
    B, T, S, H, Hkv, hd, kw, split_keys, _ = CASES["softcap_g4_hd80"]
    q, k, v = (torch.from_numpy(a) for a in _inputs(5, B, T, S, H, Hkv, hd))
    for dt, tol in ((torch.float32, TOL), (torch.bfloat16,
                                           dict(atol=3e-2, rtol=3e-2))):
        a = tref.flash_attention_split_ref(q.to(dt), k.to(dt), v.to(dt),
                                           split_keys, **kw)
        b = tref.flash_attention_fwd_ref(q.to(dt), k.to(dt), v.to(dt), **kw)
        assert a[0].dtype == dt
        torch.testing.assert_close(a[0].float(), b[0].float(), **tol)
        torch.testing.assert_close(a[1], b[1], **TOL)


# ---------------------------------------------------------------------------
# The route and the split plan: plain Python, as the wrapper runs them.
# ---------------------------------------------------------------------------
BF = torch.bfloat16


@pytest.mark.parametrize("T,H,Hkv,hd,dtype,aligned,want", [
    (1, 9, 3, 64, BF, True, "split"),          # the wave's decode
    (1, 32, 8, 128, BF, True, "split"),        # llama-vision's cross decode
    (1, 6, 6, 64, BF, True, "split"),          # whisper's cross decode
    (1, 16, 1, 64, BF, True, "split"),         # 16 rows: the whole tile
    (1, 32, 1, 64, BF, True, "wgmma"),         # 32 rows: past it
    (4, 12, 3, 64, BF, True, "split"),         # 4 tokens x g 4
    (64, 32, 8, 128, BF, True, "wgmma"),       # the cross chunk
    (1024, 9, 3, 64, BF, True, "wgmma"),       # training
    (256, 32, 32, 80, BF, True, "wgmma"),      # zamba's prefill
    (1, 9, 3, 64, BF, False, "simt"),          # unaligned rows
    (1, 9, 3, 64, torch.float32, True, "simt"),
    (64, 4, 4, 8, BF, True, "simt"),           # head_dim 8
])
def test_forward_route(T, H, Hkv, hd, dtype, aligned, want):
    way, plan = fa_mod.forward_route(T, 600, H, Hkv, hd, dtype, aligned)
    assert way == want and way in fa_mod.ROUTES
    assert (plan is not None) == (way == "split")


def test_split_plan():
    """Whole chunks of SPLIT_CHUNK keys from the window's edge, about
    SPLITS runs of them: more keys a run as S grows, never more than a
    dozen runs; never a function of the batch (the plan takes none)."""
    assert "B" not in inspect.signature(fa_mod.split_plan).parameters
    chunk = fa_mod.SPLIT_CHUNK
    assert fa_mod.split_plan(1, 50) == (0, chunk, 1)
    assert fa_mod.split_plan(1, 513) == (0, chunk, 9)        # the wave
    assert fa_mod.split_plan(1, 1500) == (0, 3 * chunk, 8)   # whisper
    assert fa_mod.split_plan(1, 1600) == (0, 3 * chunk, 9)   # llama-vision
    keys = [fa_mod.split_plan(1, S)[1] for S in (1, 64, 700, 1024, 4096,
                                                  20000, 100_000)]
    assert keys == sorted(keys) and keys[0] == chunk
    for S in range(1, 5000, 37):
        k_begin, keys, n = fa_mod.split_plan(1, S)
        assert keys % chunk == 0 and 1 <= n <= 12
        assert k_begin == 0 and (n - 1) * keys < S <= n * keys
    # The window moves the first split's left edge to the first query's.
    assert fa_mod.split_plan(1, 1024, window=256) == (768, chunk, 4)
    assert fa_mod.split_plan(8, 300, window=5) == (288, chunk, 1)
    assert fa_mod.split_plan(1, 100, window=500) == (0, chunk, 2)
    # The same plan the kernel runs cuts the plain split form's keys.
    B, T, S, H, Hkv, hd, kw, _, _ = CASES["decode_window"]
    arrays = _inputs(9, B, T, S, H, Hkv, hd)
    got, _ = _split(arrays, fa_mod.split_plan(T, S, kw["window"])[1], kw)
    want = np.asarray(jref.flash_attention_ref(*map(jnp.asarray, arrays),
                                               **kw))
    np.testing.assert_allclose(got, want, **TOL)
