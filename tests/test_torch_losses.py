"""The port's ``chunked_softmax_xent`` against the JAX package's, on the
same numpy-seeded hidden states, unembedding and labels: both layouts,
chunks of 8, 16 and 2048 tokens (and a length the chunk must halve to
divide), with and without weights, values at rtol 1e-5 and gradients at
1e-5 (float32).  The masked position gets exactly zero gradient."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.losses import chunked_softmax_xent as jxent  # noqa: E402
from repro_torch.models.losses import chunked_softmax_xent as txent  # noqa: E402,E501

jax.config.update("jax_platform_name", "cpu")


def _data(seed, B=2, T=32, D=16, V=64):
    rng = np.random.default_rng(seed)
    hidden = rng.normal(size=(B, T, D)).astype(np.float32)
    w_out = rng.normal(size=(D, V)).astype(np.float32)
    labels = rng.integers(0, V, size=(B, T)).astype(np.int32)
    weights = np.ones((B, T), np.float32)
    weights[:, -1] = 0.0
    return hidden, w_out, labels, weights


def _naive(hidden, w_out, labels, weights):
    logits = torch.einsum("btd,dv->btv", hidden, w_out)
    lse = torch.logsumexp(logits, -1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.sum((lse - ll) * weights) / torch.clamp(weights.sum(),
                                                         min=1.0)


@pytest.mark.parametrize("layout", ["flat", "batched"])
@pytest.mark.parametrize("chunk", [8, 16, 2048])
@pytest.mark.parametrize("weighted", [False, True])
def test_matches_jax_value_and_grad(layout, chunk, weighted):
    hidden, w_out, labels, weights = _data(chunk)
    w = weights if weighted else None

    def jf(h, wo):
        return jxent(h, wo, jnp.asarray(labels), token_chunk=chunk,
                     weights=None if w is None else jnp.asarray(w),
                     layout=layout)

    jval, (jgh, jgw) = jax.value_and_grad(jf, argnums=(0, 1))(
        jnp.asarray(hidden), jnp.asarray(w_out))
    h = torch.from_numpy(hidden).requires_grad_(True)
    wo = torch.from_numpy(w_out).requires_grad_(True)
    val = txent(h, wo, torch.from_numpy(labels), token_chunk=chunk,
                weights=None if w is None else torch.from_numpy(w),
                layout=layout)
    gh, gw = torch.autograd.grad(val, (h, wo))
    np.testing.assert_allclose(val.item(), float(jval), rtol=1e-5)
    np.testing.assert_allclose(gh.numpy(), np.asarray(jgh), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(gw.numpy(), np.asarray(jgw), atol=1e-5,
                               rtol=1e-5)
    want = _naive(h.detach(), wo.detach(), torch.from_numpy(labels),
                  torch.ones(labels.shape) if w is None
                  else torch.from_numpy(w))
    np.testing.assert_allclose(val.item(), float(want), rtol=1e-5)


@pytest.mark.parametrize("layout", ["flat", "batched"])
def test_chunk_halves_until_it_divides(layout):
    """T=24 with token_chunk=16: the chunk halves to 8 in both packages."""
    hidden, w_out, labels, weights = _data(5, B=3, T=24)
    want = jxent(jnp.asarray(hidden), jnp.asarray(w_out),
                 jnp.asarray(labels), token_chunk=16,
                 weights=jnp.asarray(weights), layout=layout)
    got = txent(torch.from_numpy(hidden), torch.from_numpy(w_out),
                torch.from_numpy(labels), token_chunk=16,
                weights=torch.from_numpy(weights), layout=layout)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("layout", ["flat", "batched"])
def test_masked_position_has_no_gradient(layout):
    hidden, w_out, labels, weights = _data(2)
    h = torch.from_numpy(hidden).requires_grad_(True)
    val = txent(h, torch.from_numpy(w_out), torch.from_numpy(labels),
                weights=torch.from_numpy(weights), layout=layout)
    (g,) = torch.autograd.grad(val, (h,))
    assert torch.count_nonzero(g[:, -1]) == 0
    assert float(g[:, :-1].abs().max()) > 0


def test_bf16_inputs_accumulate_in_float32():
    """bf16 hidden and unembedding: the result is float32 and equals the
    float32 computation on the same (bf16-representable) values."""
    hidden, w_out, labels, weights = _data(6)
    hb = torch.from_numpy(hidden).to(torch.bfloat16)
    wb = torch.from_numpy(w_out).to(torch.bfloat16)
    got = txent(hb, wb, torch.from_numpy(labels),
                weights=torch.from_numpy(weights), layout="batched")
    want = txent(hb.float(), wb.float(), torch.from_numpy(labels),
                 weights=torch.from_numpy(weights), layout="batched")
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
