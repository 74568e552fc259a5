"""The port's paged attention against the JAX package's oracle and its
Pallas kernel (interpret mode) on the same numpy-seeded inputs: every
case of tests/test_kernels_paged.py, a strided per-layer pool view, a
padded chunk that reaches past the block table, and softcap.  On the CPU
the port runs its plain version (the Hopper kernel is held against that
plain version on the card in test_torch_kernels_cuda.py).  Tolerance
2e-5 abs/rel (the reference's own)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.paged_attention import paged_attention as pallas_paged  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as pa_mod  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

TOL = dict(atol=2e-5, rtol=2e-5)


def _setup(seed, B, T, H, Hkv, hd, n_pages, ps, P, lens):
    """Numpy inputs, exactly as tests/test_kernels_paged.py draws them."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, T, H, hd)).astype(np.float32)
    kp = rng.normal(size=(n_pages, ps, Hkv, hd)).astype(np.float32)
    vp = rng.normal(size=(n_pages, ps, Hkv, hd)).astype(np.float32)
    block = rng.permutation(n_pages)[:B * P].reshape(B, P).astype(np.int32)
    return q, kp, vp, block, np.asarray(lens, np.int32)


def _torch(*arrays, device="cpu"):
    return [torch.from_numpy(np.array(a)).to(device) for a in arrays]


def _check(q, kp, vp, block, lens, softcap=0.0, pallas=True):
    """Port (CPU) vs JAX oracle and, where it applies, the Pallas kernel."""
    out = ops.paged_attention(*_torch(q, kp, vp, block, lens),
                              softcap=softcap).numpy()
    want = np.asarray(jref.paged_attention_ref(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(block), jnp.asarray(lens), softcap=softcap))
    np.testing.assert_allclose(out, want, **TOL)
    if pallas:
        got = np.asarray(pallas_paged(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(block), jnp.asarray(lens), softcap=softcap,
            interpret=True))
        np.testing.assert_allclose(out, got, **TOL)
    return out


CASES = {
    "decode_T1": dict(seed=0, B=3, T=1, H=4, Hkv=2, hd=32, n_pages=32,
                      ps=8, P=4, lens=[9, 1, 31]),
    "chunk_T8_causal": dict(seed=1, B=2, T=8, H=4, Hkv=4, hd=16,
                            n_pages=24, ps=8, P=3, lens=[8, 20]),
    "gqa_8_1": dict(seed=2, B=2, T=1, H=8, Hkv=1, hd=16, n_pages=16, ps=4,
                    P=4, lens=[5, 13]),
    "gqa_6_2": dict(seed=2, B=2, T=1, H=6, Hkv=2, hd=16, n_pages=16, ps=4,
                    P=4, lens=[5, 13]),
    "gqa_9_3": dict(seed=2, B=2, T=1, H=9, Hkv=3, hd=16, n_pages=16, ps=4,
                    P=4, lens=[5, 13]),
    "extent_7": dict(seed=3, B=1, T=1, H=2, Hkv=2, hd=16, n_pages=8, ps=8,
                     P=4, lens=[7]),
    "extent_8": dict(seed=3, B=1, T=1, H=2, Hkv=2, hd=16, n_pages=8, ps=8,
                     P=4, lens=[8]),
    "extent_9": dict(seed=3, B=1, T=1, H=2, Hkv=2, hd=16, n_pages=8, ps=8,
                     P=4, lens=[9]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_oracle_and_pallas(name):
    _check(*_setup(**CASES[name]))


def test_softcap_matches_oracle_and_pallas():
    _check(*_setup(6, B=2, T=4, H=6, Hkv=2, hd=16, n_pages=16, ps=4, P=4,
                   lens=[7, 16]), softcap=5.0)


def _poison(q, kp, vp, block, lens):
    """Redirect every out-of-extent block entry to a page FULL of 1e4."""
    poison = np.full((1,) + kp.shape[1:], 1e4, kp.dtype)
    ps, P = kp.shape[1], block.shape[1]
    used = lens[:, None] > np.arange(P) * ps
    block2 = np.where(used, block, kp.shape[0]).astype(np.int32)
    return (q, np.concatenate([kp, poison]), np.concatenate([vp, poison]),
            block2, lens)


def test_garbage_pages_cannot_leak():
    """Entries past a row's extent point at poison pages; the output must
    depend only on the row's own prefix (bit for bit)."""
    inputs = _setup(4, B=2, T=1, H=4, Hkv=2, hd=16, n_pages=32, ps=4, P=8,
                    lens=[6, 10])
    out = _check(*inputs)
    out2 = _check(*_poison(*inputs))
    np.testing.assert_array_equal(out, out2)


def test_zero_length_row_outputs_zero():
    q, kp, vp, block, lens = _setup(5, B=2, T=1, H=2, Hkv=2, hd=16,
                                    n_pages=16, ps=4, P=4, lens=[0, 11])
    block[0] = 0
    out = _check(q, kp, vp, block, lens)
    np.testing.assert_array_equal(out[0], 0.0)


def _pool_view(seed, n_pages=24, ps=4, L=3, Hkv=2, hd=16, li=1):
    """A [n_pages, ps, L, Hkv, hd] pool and its layer-li numpy slice."""
    rng = np.random.default_rng(seed)
    pk = rng.normal(size=(n_pages, ps, L, Hkv, hd)).astype(np.float32)
    pv = rng.normal(size=(n_pages, ps, L, Hkv, hd)).astype(np.float32)
    return pk, pv, li


def test_strided_per_layer_pool_view():
    """The port reads one layer's non-contiguous view pool[:, :, li] of
    the [n_pages, ps, L, Hkv, hd] pool in place; the answer equals the
    oracle on that layer's contiguous slice."""
    pk, pv, li = _pool_view(7)
    q, _, _, block, lens = _setup(8, B=3, T=4, H=6, Hkv=2, hd=16,
                                  n_pages=24, ps=4, P=5, lens=[4, 13, 20])
    tk, tv = _torch(pk, pv)
    kview, vview = tk[:, :, li], tv[:, :, li]
    assert not kview.is_contiguous()
    out = ops.paged_attention(*_torch(q), kview, vview,
                              *_torch(block, lens)).numpy()
    want = np.asarray(jref.paged_attention_ref(
        jnp.asarray(q), jnp.asarray(pk[:, :, li]), jnp.asarray(pv[:, :, li]),
        jnp.asarray(block), jnp.asarray(lens)))
    np.testing.assert_allclose(out, want, **TOL)


def test_padded_chunk_past_the_table():
    """A padded final chunk can put cache_pos + T past P * ps: the row's
    queries still see exactly their causal prefix (the Pallas grid
    cannot express this shape; the oracle can)."""
    inputs = _setup(9, B=2, T=8, H=4, Hkv=2, hd=16, n_pages=16, ps=4, P=3,
                    lens=[14, 5])
    _check(*inputs, pallas=False)


def test_wrapper_rejects_other_devices():
    q, kp, vp, block, lens = _torch(*_setup(**CASES["decode_T1"]))
    with pytest.raises(ValueError):
        pa_mod.paged_attention(q.to("meta"), kp, vp, block, lens)
