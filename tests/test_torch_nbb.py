"""The port's NBB matmul on the CPU — ``ops.nbb_matmul``, which runs
``ref.matmul_ref`` for a CPU tensor — against the JAX package's Pallas
``nbb_matmul`` in interpret mode, on the same numpy-seeded inputs: the
shapes of ``tests/test_kernels.py`` in float32 (atol 5e-4, rtol 1e-3: a
K-blocked against a single-dot accumulation order) and bfloat16 (3e-2),
and the odd K-tile count at 2e-5.  Also the reference's block contract
(clamping, divisibility errors) and the checks the wrapper makes before
the copy engine sees an operand."""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.nbb_matmul import nbb_matmul as jnbb  # noqa: E402
from repro_torch.kernels import nbb_matmul as nbb_mod  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

TOL = {"float32": dict(atol=5e-4, rtol=1e-3),
       "bfloat16": dict(atol=3e-2, rtol=3e-2)}


def _inputs(seed, M, K, N):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(M, K)).astype(np.float32),
            rng.normal(size=(K, N)).astype(np.float32))


def _both(a, b, dtype, **blocks):
    """(port, JAX) outputs as float32 numpy."""
    jdt = getattr(jnp, dtype)
    want = jnbb(jnp.asarray(a, jdt), jnp.asarray(b, jdt), interpret=True,
                **blocks)
    tdt = getattr(torch, dtype)
    got = ops.nbb_matmul(torch.from_numpy(a).to(tdt),
                         torch.from_numpy(b).to(tdt), **blocks)
    assert got.dtype == tdt
    return got.float().numpy(), np.asarray(want, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N,bm,bn,bk", [
    (256, 512, 256, 128, 128, 128),   # 4-deep K pipeline
    (128, 128, 128, 128, 128, 128),   # single K step (ring primes only)
    (512, 1024, 256, 256, 256, 256),
])
def test_nbb_matmul_matches_jax(M, K, N, bm, bn, bk, dtype):
    """``test_kernels.py::test_nbb_matmul_matches_ref``: the reference
    holds its kernel to ``ref.matmul_ref``; the port's entry point (its
    plain version on the CPU) is held to that kernel, at its tolerance."""
    before = nbb_mod.launches
    got, want = _both(*_inputs(M + K + N, M, K, N), dtype, bm=bm, bn=bn,
                      bk=bk)
    np.testing.assert_allclose(got, want, **TOL[dtype])
    assert nbb_mod.launches == before      # the CPU runs the plain version


def test_nbb_matmul_odd_k_depth_matches_jax():
    """Odd K-tile count: the last slot's parity differs from the primed
    slot's (``test_kernels.py::test_nbb_matmul_odd_k_depth``)."""
    got, want = _both(*_inputs(22, 128, 384, 128), "float32", bm=128,
                      bn=128, bk=128)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


def test_nbb_matmul_default_blocks_clamp_to_the_shape():
    """Defaults 256 x 256 x 512 clamp to a small shape: M=96, K=40, N=72
    pass as one block each, in both packages."""
    got, want = _both(*_inputs(3, 96, 40, 72), "float32")
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("M,K,N,bm,bn,bk", [
    (192, 128, 128, 128, 128, 128),   # M % bm
    (128, 128, 192, 128, 128, 128),   # N % bn
    (128, 192, 128, 128, 128, 128),   # K % bk
])
def test_nbb_matmul_divisibility_errors(M, K, N, bm, bn, bk):
    a, b = _inputs(4, M, K, N)
    blocks = dict(bm=bm, bn=bn, bk=bk)
    with pytest.raises(AssertionError):
        jnbb(jnp.asarray(a), jnp.asarray(b), interpret=True, **blocks)
    with pytest.raises(ValueError, match="not a multiple"):
        ops.nbb_matmul(torch.from_numpy(a), torch.from_numpy(b), **blocks)


def test_nbb_matmul_shape_errors():
    a = torch.zeros(8, 16)
    with pytest.raises(ValueError, match="does not fit"):
        ops.nbb_matmul(a, torch.zeros(8, 16))
    with pytest.raises(ValueError, match="expected"):
        ops.nbb_matmul(a[None], torch.zeros(16, 8))


def test_cuda_checks_refuse_what_the_copy_engine_cannot_take():
    """The checks the wrapper makes before a launch: contiguous rows, one
    dtype, 16-byte rows (here on CPU tensors, which reach them only
    through this call)."""
    a, b = torch.zeros(64, 64), torch.zeros(64, 64)
    nbb_mod._check_cuda(a, b)                           # fine
    with pytest.raises(ValueError, match="contiguous"):
        nbb_mod._check_cuda(a, torch.zeros(64, 64).T)
    with pytest.raises(TypeError, match="share one dtype"):
        nbb_mod._check_cuda(a, b.to(torch.bfloat16))
    with pytest.raises(TypeError, match="not supported"):
        nbb_mod._check_cuda(a.double(), b.double())
    with pytest.raises(ValueError, match="16-byte"):
        nbb_mod._check_cuda(torch.zeros(64, 6), torch.zeros(6, 64))
    with pytest.raises(ValueError, match="16-byte"):
        nbb_mod._check_cuda(torch.zeros(64, 64, dtype=torch.bfloat16),
                            torch.zeros(64, 4, dtype=torch.bfloat16))


def test_tile_constant_matches_the_source():
    """The wrapper's per-instance tiles are the source's ``kTiles``, and
    the source builds the NBB ring the way the wrapper documents it: TMA
    tensor maps filling full/empty mbarrier slots for the bf16 ``wgmma``
    instances, row-wise bulk copies for the f32 one.  The PTX of those
    pieces may sit in a header the source includes (``hopper.cuh``, shared
    with the flash backward)."""
    src = nbb_mod.SOURCE.read_text()
    headers = re.findall(r'#include "(\w+\.cuh)"', src)
    assert headers, "no shared header included"
    text = src + "".join((nbb_mod.SOURCE.parent / h).read_text()
                         for h in headers)
    rows = re.findall(r"\{(\d+), (\d+), (\d+), (\d+)\},\s+// (\d): (\w+)",
                      src)
    assert [int(r[4]) for r in rows] == list(range(len(nbb_mod.INSTANCES)))
    for r, (dtype, m, n, k, slots) in zip(rows, nbb_mod.INSTANCES):
        assert tuple(map(int, r[:4])) == (m, n, k, slots)
        assert r[5] == dtype
    assert nbb_mod.TILE == tuple(i[1:4] for i in nbb_mod.INSTANCES)
    assert nbb_mod.SLOTS == tuple(i[4] for i in nbb_mod.INSTANCES)
    for needle in ("mbarrier.try_wait.parity", "mbarrier.arrive.expect_tx",
                   "cp.async.bulk.shared::cluster.global.mbarrier",
                   "cp.async.bulk.tensor.2d", "cuTensorMapEncodeTiled",
                   "cudaGetDriverEntryPoint", "__grid_constant__",
                   "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16",
                   "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16",
                   "CU_TENSOR_MAP_SWIZZLE_128B"):
        assert needle in text, needle


@pytest.mark.parametrize("dtype,M,N,want", [
    (torch.float32, 4096, 4096, 0),
    (torch.bfloat16, 512, 512, 1),       # 16 blocks of 128 x 128: too few
    (torch.bfloat16, 100, 72, 1),
    (torch.bfloat16, 1408, 1536, 2),     # 11 x 12 = 132 blocks: one wave
    (torch.bfloat16, 1400, 1400, 1),     # 11 x 11 = 121
    (torch.bfloat16, 4096, 4096, 2),
])
def test_instance_for_shape(dtype, M, N, want):
    assert nbb_mod.instance_for(dtype, M, N) == want


def test_instances_fit_the_ring_rules():
    """Every bf16 instance steps K by 64 (one 128-byte swizzle row), tiles
    M by whole 64-row warpgroups and N by whole 64-column TMA boxes, and
    its ring fits a block's 227 KB of shared memory."""
    for dtype, m, n, k, slots in nbb_mod.INSTANCES[1:]:
        assert dtype == "bfloat16" and k == 64
        assert m % 64 == 0 and n % 64 == 0 and slots >= 3
        assert slots * (m * k + k * n) * 2 + 1024 <= 232448


def test_matmul_ref_matches_jax_ref():
    a, b = _inputs(5, 32, 48, 16)
    for dtype in ("float32", "bfloat16"):
        jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
        want = np.asarray(jref.matmul_ref(jnp.asarray(a, jdt),
                                          jnp.asarray(b, jdt)), np.float32)
        got = tref.matmul_ref(torch.from_numpy(a).to(tdt),
                              torch.from_numpy(b).to(tdt))
        assert got.dtype == tdt
        np.testing.assert_allclose(got.float().numpy(), want, **TOL[dtype])
