"""Counterparts of the flash tests of ``tests/test_kernels.py`` and of
``tests/test_kernels_decode.py``: the port's ``ops`` entry points on the
CPU (their plain PyTorch versions) against the JAX package's Pallas
kernel in interpret mode, and ``flash_attention_trainable``'s gradients
against ``jax.grad`` of the JAX package's, on the same numpy-seeded
inputs.  The shapes and the tolerances are the reference test's: 2e-5 in
float32, 3e-2 in bfloat16 (both packages get the same bf16-rounded
inputs), 1e-4 for gradients.  The reference's VMEM budget becomes the
kernels' shared memory at their production tiles against an H100
block's opt-in limit, from the tile constants the wrappers expose and
this file checks against the CUDA sources."""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import (  # noqa: E402
    flash_attention as jflash, flash_attention_trainable as jtrainable)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import nbb_matmul as nbb  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=3e-2, rtol=3e-2)}


def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _both(arrays, dtype):
    """The same values for each package: jnp and torch arrays in dtype."""
    jx = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return jx, tx


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,T,S,H,Hkv,hd",
    [
        (1, 128, 128, 4, 4, 64),     # MHA square
        (2, 128, 256, 8, 2, 64),     # GQA, decode-suffix (T < S)
        (1, 256, 256, 6, 3, 128),    # group=2, 128 head_dim
    ])
def test_flash_attention_matches_ref(B, T, S, H, Hkv, hd, dtype):
    (jq, jk, jv), (q, k, v) = _both(_inputs(
        B * T + S + H + hd, (B, T, H, hd), (B, S, Hkv, hd), (B, S, Hkv, hd)),
        dtype)
    want = jflash(jq, jk, jv, causal=True, block_q=128, block_k=128,
                  interpret=True)
    got = ops.flash_attention(q, k, v, causal=True)
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, T, H, hd)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("window", [128, 512])
def test_flash_attention_sliding_window(window):
    B, T, H, hd = 1, 512, 4, 64
    (jq, jk, jv), (q, k, v) = _both(_inputs(
        3, (B, T, H, hd), (B, T, H, hd), (B, T, H, hd)), "float32")
    want = jflash(jq, jk, jv, causal=True, window=window, interpret=True)
    _close(ops.flash_attention(q, k, v, causal=True, window=window), want,
           TOL["float32"])


def test_flash_attention_softcap():
    B, T, H, hd = 1, 128, 2, 64
    (jq, jk, jv), (q, k, v) = _both(_inputs(
        6, (B, T, H, hd), (B, T, H, hd), (B, T, H, hd)), "float32")
    want = jflash(jq, jk, jv, softcap=50.0, interpret=True)
    _close(ops.flash_attention(q, k, v, softcap=50.0), want, TOL["float32"])


def test_flash_attention_noncausal():
    B, T, S, H, hd = 1, 128, 256, 4, 64
    (jq, jk, jv), (q, k, v) = _both(_inputs(
        9, (B, T, H, hd), (B, S, H, hd), (B, S, H, hd)), "float32")
    want = jflash(jq, jk, jv, causal=False, interpret=True)
    _close(ops.flash_attention(q, k, v, causal=False), want, TOL["float32"])


def test_flash_attention_grad_matches_ref():
    """The trainable flash's gradients of the output's sum: the port's
    autograd Function (plain forward and backward on the CPU) against
    ``jax.grad`` through the JAX package's interpret-mode kernel."""
    B, T, H, hd = 1, 128, 2, 64
    arrays = _inputs(12, (B, T, H, hd), (B, T, H, hd), (B, T, H, hd))
    (jq, jk, jv), tx = _both(arrays, "float32")

    def f_kern(q, k, v):
        return jtrainable(q, k, v, True, 0, 0.0, 128, 128, True).sum()

    want = jax.grad(f_kern, argnums=(0, 1, 2))(jq, jk, jv)
    leaves = [t.requires_grad_(True) for t in tx]
    got = torch.autograd.grad(
        ops.flash_attention_trainable(*leaves).sum(), leaves)
    for a, b in zip(got, want):
        _close(a, b, dict(atol=1e-4, rtol=1e-4))


def test_decode_with_window():
    """One query over a 1024-key history under a 256-key window."""
    B, S, H, hd = 1, 1024, 4, 64
    (jq, jk, jv), (q, k, v) = _both(_inputs(
        3, (B, 1, H, hd), (B, S, H, hd), (B, S, H, hd)), "float32")
    want = jflash(jq, jk, jv, causal=True, window=256, interpret=True)
    _close(ops.flash_attention(q, k, v, causal=True, window=256), want,
           TOL["float32"])


def test_production_tile_fits_vmem():
    """The reference holds its production flash tile's working set under
    16 MB of VMEM; here every tensor-core route's shared memory at its
    production tiles fits an H100 block's opt-in limit (227 KB): flash's
    split and ``wgmma`` forward at every head dim, the backward's dQ and
    dK/dV passes (two warpgroups a block), paged attention's split and
    chunk routes (at their most warpgroups) and the NBB ring.  The card
    adds each kernel's static bytes and checks the sum against the card
    (``test_torch_kernels_cuda.py::test_shared_memory_fits_the_card``)."""
    requests = {**fa.smem_requests(), **fa.smem_requests(backward=True),
                **pa.smem_requests(), **nbb.smem_requests()}
    tiles = {k: v for k, v in requests.items() if "simt" not in k}
    assert len(tiles) == 15 + 20 + 15 + 2
    assert all(0 < v < build.SMEM_PER_BLOCK for v in tiles.values()), tiles
    assert build.SMEM_PER_BLOCK == 227 * 1024


def _const(text, name, namespace=None):
    """The value of ``constexpr int name = <int>;`` in ``text``, inside
    ``namespace <namespace> {`` when given."""
    if namespace is not None:
        start = text.index(f"namespace {namespace} {{")
        text = text[start:text.index(f"}}  // namespace {namespace}", start)]
    (value,) = re.findall(rf"constexpr int {name} = (\d+);", text)
    return int(value)


def test_smem_constants_match_the_sources():
    """The tile constants the wrappers size shared memory with are the
    sources' own."""
    csrc = build.CSRC
    common = (csrc / "flash_common.cuh").read_text()
    tiles = (csrc / "flash_tiles.cuh").read_text()
    fwd = fa.SOURCE.read_text()
    bwd = fa.BWD_SOURCE.read_text()
    paged = pa.SOURCE.read_text()
    assert _const(common, "kMaxSmemBytes") == build.SMEM_PER_BLOCK
    assert _const(nbb.SOURCE.read_text(), "kMaxSmemBytes") == \
        build.SMEM_PER_BLOCK
    assert _const(tiles, "kRows", "tc") == fa.TILE_ROWS
    assert "kSlots = HD >= 128 ? 2 : 3;" in tiles
    assert [fa.tile_slots(hd) for hd in fa.TC_HEAD_DIMS] == [3, 3, 3, 3, 2]
    assert _const(fwd, "kRows", "split") == fa.SPLIT_ROWS
    assert _const(fwd, "kChunk", "split") == fa.SPLIT_CHUNK
    assert _const(fwd, "kMaxSplits", "split") == fa.SPLIT_MAX
    assert _const(fwd, "kStages", "wg") == fa.WGMMA_STAGES
    assert _const(bwd, "kWarpgroups", "tc") == fa.BWD_WARPGROUPS
    assert _const(paged, "kKeys") == pa.SPLIT_TILE
    assert _const(paged, "kRows", "split") == pa.SPLIT_ROWS
    assert _const(paged, "kMaxSplits", "split") == pa.SPLIT_MAX
    assert _const(paged, "kStages", "chunk") == pa.CHUNK_STAGES
    assert _const(paged, "kMaxSplits", "chunk") == pa.CHUNK_SPLITS
    assert "kMaxWG = HD >= 128 ? 2 : 3;" in paged
    assert [pa.chunk_warpgroups(hd) for hd in fa.TC_HEAD_DIMS] == \
        [3, 3, 3, 3, 2]
