"""The port's flash backward on the CPU: ``ref.flash_attention_bwd_ref``
(the equations of the Hopper backward kernel, written out in tensors)
on the residuals of ``ref.flash_attention_fwd_ref``, against ``jax.grad``
of the JAX package's ``flash_attention_trainable`` (its Pallas forward in
interpret mode, its jnp VJP), on the same numpy-seeded inputs, at the
reference's gradient tolerance 1e-4 in float32.  Cases: the one of
``tests/test_kernels.py:86``, GQA 9:3 and 12:4, a window of 40 with a
softcap of 30, non-causal with T < S, and ragged T and S.  Besides: the
forward's log-sum-exp against ``torch.logsumexp`` of the masked scores,
and ``flash_attention_trainable`` on the CPU (whose backward is the plain
version) against autograd through ``ref.flash_attention_ref``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import (  # noqa: E402
    flash_attention_trainable as jfa_trainable)
from repro_torch.kernels import flash_attention as fa_mod  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

# name: (B, T, S, H, Hkv, hd, causal, window, softcap).  The Pallas kernel
# needs S % block_k == 0 and T % block_q == 0, so each case runs it with
# blocks of min(128, T) queries and min(128, S) keys; the ragged case
# (T=37, S=101) uses whole-sequence blocks.
CASES = {
    "test_kernels_86": (1, 128, 128, 2, 2, 64, True, 0, 0.0),
    "gqa_9_3": (1, 128, 128, 9, 3, 64, True, 0, 0.0),
    "gqa_12_4": (1, 128, 128, 12, 4, 32, True, 0, 0.0),
    "window_40_softcap_30": (2, 128, 128, 6, 2, 64, True, 40, 30.0),
    "noncausal_t_lt_s": (1, 64, 128, 4, 2, 64, False, 0, 0.0),
    "ragged_37_101": (2, 37, 101, 9, 3, 64, True, 0, 0.0),
    "ragged_noncausal_window": (1, 45, 77, 6, 2, 32, False, 20, 0.0),
}
TOL = dict(atol=1e-4, rtol=1e-4)


def _inputs(seed, B, T, S, H, Hkv, hd):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32) for shape in (
        (B, T, H, hd), (B, S, Hkv, hd), (B, S, Hkv, hd), (B, T, H, hd)))


def _blocks(T, S):
    if T % min(128, T) or S % min(128, S):
        return T, S
    return min(128, T), min(128, S)


def _jax_grads(q, k, v, g, causal, window, softcap):
    bq, bk = _blocks(q.shape[1], k.shape[1])

    def loss(q, k, v):
        out = jfa_trainable(q, k, v, causal, window, softcap, bq, bk, True)
        return jnp.sum(out * jnp.asarray(g))

    return [np.asarray(x) for x in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_backward_matches_jax_grad(name):
    B, T, S, H, Hkv, hd, causal, window, softcap = CASES[name]
    q, k, v, g = _inputs(len(name), B, T, S, H, Hkv, hd)
    want = _jax_grads(q, k, v, g, causal, window, softcap)
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    kw = dict(causal=causal, window=window, softcap=softcap)
    out, lse = tref.flash_attention_fwd_ref(tq, tk, tv, **kw)
    got = tref.flash_attention_bwd_ref(tq, tk, tv, out, lse, tg, **kw)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, **TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_lse_matches_logsumexp_of_masked_scores(name):
    """lse [B, H, T]: head h = kv head * g + group index, each row the
    natural log-sum-exp of its scaled, capped scores over visible keys."""
    B, T, S, H, Hkv, hd, causal, window, softcap = CASES[name]
    q, k, v, _ = map(torch.from_numpy, _inputs(len(name) + 1, B, T, S, H,
                                               Hkv, hd))
    out, lse = tref.flash_attention_fwd_ref(q, k, v, causal=causal,
                                            window=window, softcap=softcap)
    assert lse.shape == (B, H, T) and lse.dtype == torch.float32
    torch.testing.assert_close(out, tref.flash_attention_ref(
        q, k, v, causal=causal, window=window, softcap=softcap),
        atol=0, rtol=0)
    kvh = torch.arange(H) // (H // Hkv)
    s = torch.einsum("bthd,bshd->bhts", q, k[:, :, kvh]) * hd ** -0.5
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    qp = torch.arange(T)[:, None] + S - T
    kp = torch.arange(S)[None, :]
    visible = torch.ones(T, S, dtype=torch.bool)
    if causal:
        visible &= kp <= qp
    if window:
        visible &= kp > qp - window
    want = torch.logsumexp(s.masked_fill(~visible, float("-inf")), dim=-1)
    torch.testing.assert_close(lse, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", ["test_kernels_86", "window_40_softcap_30",
                                  "ragged_37_101"])
def test_trainable_on_cpu_matches_autograd_through_plain(name):
    """On the CPU the autograd function's forward and backward are the
    plain versions; its gradients equal autograd's through
    ``flash_attention_ref`` to f32 summation order (2e-5), and it
    launches no kernel."""
    B, T, S, H, Hkv, hd, causal, window, softcap = CASES[name]
    q, k, v, g = map(torch.from_numpy, _inputs(len(name) + 2, B, T, S, H,
                                               Hkv, hd))
    kw = dict(causal=causal, window=window, softcap=softcap)
    before = (fa_mod.launches, fa_mod.bwd_launches, fa_mod.simt_launches)
    results = []
    for fn in (ops.flash_attention_trainable, tref.flash_attention_ref):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*leaves, **kw)
        results.append((out.detach(),)
                       + torch.autograd.grad(out, leaves, g))
    assert (fa_mod.launches, fa_mod.bwd_launches,
            fa_mod.simt_launches) == before
    for a, b in zip(*results):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=2e-5)


def test_plain_backward_rows_without_keys_are_zero():
    """Causal with S < T: the first T - S queries see no key.  The kernel
    returns 0 there, and the plain backward gives those rows P = 0, so
    their dq is 0 and they add nothing to dk and dv."""
    q, k, v, g = map(torch.from_numpy, _inputs(3, 1, 10, 6, 4, 2, 16))
    out, lse = tref.flash_attention_fwd_ref(q, k, v)
    dq, dk, dv = tref.flash_attention_bwd_ref(q, k, v, out, lse, g)
    assert torch.count_nonzero(dq[:, :4]) == 0
    sub_out, sub_lse = tref.flash_attention_fwd_ref(q[:, 4:], k, v)
    want = tref.flash_attention_bwd_ref(q[:, 4:], k, v, sub_out, sub_lse,
                                        g[:, 4:])
    torch.testing.assert_close(dq[:, 4:], want[0], atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(dk, want[1], atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(dv, want[2], atol=1e-6, rtol=1e-6)


def test_bwd_entry_on_cpu_is_the_plain_version():
    """``ops.flash_attention_bwd`` runs the plain backward for CPU
    tensors, bit for bit, and launches nothing."""
    q, k, v, g = map(torch.from_numpy, _inputs(4, 2, 37, 101, 9, 3, 64))
    out, lse = ops.flash_attention_fwd(q, k, v, window=30)
    before = fa_mod.bwd_launches
    got = ops.flash_attention_bwd(q, k, v, out, lse, g, window=30)
    want = tref.flash_attention_bwd_ref(q, k, v, out, lse, g, window=30)
    assert fa_mod.bwd_launches == before
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_tensor_core_route_choice():
    """bf16 rows of 16/32/64/80/128 elements, 16-byte aligned, take the
    tensor-core kernels; float32, other head dims and unaligned strides
    take the CUDA-core ones."""
    bf = torch.zeros((2, 8, 4, 64), dtype=torch.bfloat16)
    assert fa_mod.tensor_core_route(bf, bf)
    assert fa_mod.tensor_core_route(
        torch.zeros((2, 8, 4, 80), dtype=torch.bfloat16))
    assert not fa_mod.tensor_core_route(bf.float())
    assert not fa_mod.tensor_core_route(
        torch.zeros((2, 8, 4, 48), dtype=torch.bfloat16))
    wide = torch.zeros((2, 8, 4, 68), dtype=torch.bfloat16)
    assert not fa_mod.tensor_core_route(bf, wide[..., :64])
    shifted = torch.zeros(1 + bf.numel(), dtype=torch.bfloat16)[1:]
    assert not fa_mod.tensor_core_route(bf, shifted.view(bf.shape))
