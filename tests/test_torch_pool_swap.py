"""The paged pool's ``grow`` and its retired dense swap pair
(``swap_in``/``swap_out``: no scheduler calls them, in either package)
against the JAX package's ``PagedKVPool``: the counterparts of
``tests/test_serve.py::test_pool_admit_grow_free`` and
``test_pool_swap_roundtrip``, and one sequence of claims, growths, swaps
and frees run through both pools on the same numpy K/V, with the status
codes, free-page counts, ``kv_copy_bytes`` and gathered K/V equal."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.serve import kv_cache as jkv  # noqa: E402
from repro_torch.serve import kv_cache as tkv  # noqa: E402
from repro_torch.serve.kv_cache import OK, POOL_FULL, PagedKVPool  # noqa: E402

jax.config.update("jax_platform_name", "cpu")


def test_pool_admit_grow_free():
    pool = PagedKVPool(8, page_size=4, n_layers=2, kv_heads=2, head_dim=8,
                       device="cpu")
    assert pool.try_admit(0, 10) == OK          # 3 pages
    assert pool.free_pages() == 5
    assert pool.grow(0, 13) == OK               # 4th page
    assert pool.free_pages() == 4
    assert pool.table(0).n_tokens == 13
    assert pool.try_admit(1, 17) == POOL_FULL   # needs 5 > 4 free
    assert pool.free_pages() == 4               # all-or-nothing rollback
    pool.free(0)
    assert pool.free_pages() == 8
    assert pool.try_admit(1, 17) == OK


def test_grow_is_all_or_nothing():
    pool = PagedKVPool(4, page_size=4, n_layers=1, kv_heads=1, head_dim=8,
                       device="cpu")
    assert pool.try_admit(0, 4) == OK
    assert pool.try_admit(1, 8) == OK           # 1 page left
    before = list(pool.table(0).pages)
    assert pool.grow(0, 12) == POOL_FULL        # needs 2
    assert pool.table(0).pages == before and pool.table(0).n_tokens == 4
    assert pool.free_pages() == 1
    assert pool.grow(0, 8) == OK
    assert pool.free_pages() == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pool_swap_roundtrip(dtype):
    pool = PagedKVPool(8, page_size=4, n_layers=3, kv_heads=2, head_dim=8,
                       dtype=dtype, device="cpu")
    n_tok = 10
    assert pool.try_admit(5, n_tok) == OK
    g = torch.Generator().manual_seed(0)
    k = torch.randn((n_tok, 3, 2, 8), generator=g).to(dtype)
    v = torch.randn((n_tok, 3, 2, 8), generator=g).to(dtype)
    assert pool.swap_out(5, k, v, n_tok) == OK
    k2, v2 = pool.swap_in(5, max_len=16)
    assert k2.shape == (16, 3, 2, 8) and k2.dtype == dtype
    assert torch.equal(k2[:n_tok], k) and torch.equal(v2[:n_tok], v)
    assert not k2[n_tok:].any() and not v2[n_tok:].any()
    # The retired pair charges kv_copy_bytes alone: 3 pages out, 3 in.
    assert pool.kv_copy_bytes == 6 * pool.page_nbytes
    assert pool.swap_in_bytes == pool.swap_out_bytes == 0
    # The sink page (masked writes) is never written by a swap.
    assert not pool.store_k[pool.n_pages].any()


def test_grow_and_swaps_match_reference():
    """The same claims, growths (one refused), swaps and frees through
    both pools, on the same numpy K/V: every status, free-page count,
    block table and ``kv_copy_bytes`` equal, and the gathered K/V
    bit-identical in float32."""
    shape = dict(n_pages=10, page_size=4, n_layers=2, kv_heads=2, head_dim=8)
    jp = jkv.PagedKVPool(**shape, dtype=jnp.float32)
    tp = tkv.PagedKVPool(**shape, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(7)

    def kv(n):
        return [rng.standard_normal((n, 2, 2, 8)).astype(np.float32)
                for _ in range(2)]

    def both(name, *args):
        a = getattr(jp, name)(*args)
        b = getattr(tp, name)(*[torch.from_numpy(x)
                                if isinstance(x, np.ndarray) else x
                                for x in args])
        return a, b

    def same_state():
        assert jp.free_pages() == tp.free_pages()
        assert jp.kv_copy_bytes == tp.kv_copy_bytes
        assert ({s: t.pages for s, t in jp._tables.items()}
                == {s: t.pages for s, t in tp._tables.items()})

    def gathered(seq, max_len):
        (jk, jv), (tk, tv) = both("swap_in", seq, max_len)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))

    steps = [("try_admit", 0, 6), ("try_admit", 1, 3), ("grow", 0, 9),
             ("swap_out", 1, *kv(7), 7), ("grow", 1, 30),
             ("swap_out", 0, *kv(17), 17), ("free", 1),
             ("swap_out", 0, *kv(20), 20), ("try_admit", 2, 12),
             ("swap_out", 2, *kv(5), 12)]
    for name, *args in steps:
        a, b = both(name, *args)
        assert a == b, (name, a, b)
        same_state()
        for seq in jp._tables:
            gathered(seq, 24)
            same_state()
    assert tp.kv_copy_bytes > 0
