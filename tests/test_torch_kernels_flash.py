"""Counterparts of the flash tests of ``tests/test_kernels.py``: the
port's ``ops`` entry points on the CPU (their plain PyTorch versions)
against the JAX package's Pallas kernel in interpret mode, and
``flash_attention_trainable``'s gradients against ``jax.grad`` of the
JAX package's, on the same numpy-seeded inputs.  The shapes and the
tolerances are the reference test's: 2e-5 in float32, 3e-2 in bfloat16
(both packages get the same bf16-rounded inputs), 1e-4 for gradients."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import (  # noqa: E402
    flash_attention as jflash, flash_attention_trainable as jtrainable)
from repro_torch.kernels import ops  # noqa: E402

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
