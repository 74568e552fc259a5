"""Counterparts of ``tests/test_kernels_paged.py``'s shape cases: the
port's ``ops.paged_attention`` on the CPU (its plain PyTorch version)
against the JAX package's Pallas kernel in interpret mode, on the same
numpy-seeded inputs at the reference test's shapes and its tolerance,
2e-5 in float32: a one-token decode over scattered pages, a T=8 chunk
causal within itself, GQA groups of 8, 3 and 3 query heads per kv head,
and rows ending just before, at and just past a page boundary.  Then
the groups of 5 and 7 (qwen3-14b's 40/8 heads and arctic-480b's 56/8,
at 10/2 and 14/2), through the plain version and the split-KV plain
version (``ref.paged_attention_split_ref``, the kernel's split-route
arithmetic) alike."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.paged_attention import (  # noqa: E402
    paged_attention as jpaged)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

TOL = dict(atol=2e-5, rtol=2e-5)


def _setup(seed, B, T, H, Hkv, hd, n_pages, ps, P, lens):
    """tests/test_kernels_paged.py's inputs: float32 q and pages, rows on
    disjoint scattered pages (the pool allocator's invariant)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, T, H, hd)).astype(np.float32)
    kp = rng.normal(size=(n_pages, ps, Hkv, hd)).astype(np.float32)
    vp = rng.normal(size=(n_pages, ps, Hkv, hd)).astype(np.float32)
    block = rng.permutation(n_pages)[:B * P].reshape(B, P).astype(np.int32)
    return q, kp, vp, block, np.asarray(lens, np.int32)


def _check(arrays, split_keys=()):
    want = jpaged(*(jnp.asarray(a) for a in arrays), interpret=True)
    args = [torch.from_numpy(a) for a in arrays]
    got = ops.paged_attention(*args)
    assert got.dtype == torch.float32 and got.shape == arrays[0].shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for sk in split_keys:
        split = tref.paged_attention_split_ref(*args, split_keys=sk)
        np.testing.assert_allclose(split.numpy(), np.asarray(want), **TOL)


def test_decode_single_query():
    """T=1 against scattered pages: the steady-state decode shape."""
    _check(_setup(0, B=3, T=1, H=4, Hkv=2, hd=32, n_pages=32, ps=8, P=4,
                  lens=[9, 1, 31]))


def test_chunk_query_causal_within_chunk():
    """T=8 (a prompt chunk): later chunk tokens see earlier ones, all
    masked to the row's true extent."""
    _check(_setup(1, B=2, T=8, H=4, Hkv=4, hd=16, n_pages=24, ps=8, P=3,
                  lens=[8, 20]))


@pytest.mark.parametrize("H,Hkv", [(8, 1), (6, 2), (9, 3)])
def test_gqa_group_sizes(H, Hkv):
    _check(_setup(2, B=2, T=1, H=H, Hkv=Hkv, hd=16, n_pages=16, ps=4, P=4,
                  lens=[5, 13]))


@pytest.mark.parametrize("T", [1, 4])
@pytest.mark.parametrize("H,Hkv", [(10, 2), (14, 2)])
def test_odd_gqa_groups_5_and_7(H, Hkv, T):
    """Groups of 5 and 7 query heads per kv head, one-token decode and a
    T=4 chunk (20 and 28 rows of a kv head: no power of two), over rows
    of T, T + 3, 13 and 16 keys: the plain version and the split form at
    runs of 4 and 8 keys (runs wholly past a row's keys) against the
    Pallas kernel."""
    _check(_setup(4, B=4, T=T, H=H, Hkv=Hkv, hd=16, n_pages=24, ps=4, P=4,
                  lens=[T, 3 + T, 13, 16]), split_keys=(4, 8))


@pytest.mark.parametrize("length", [7, 8, 9])
def test_page_boundary_extents(length):
    """Rows ending just before / exactly at / just past a page boundary
    (ps=8) mask precisely to their extent."""
    _check(_setup(3, B=1, T=1, H=2, Hkv=2, hd=16, n_pages=8, ps=8, P=4,
                  lens=[length]))
