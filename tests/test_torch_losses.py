"""The port's ``chunked_softmax_xent`` against the JAX package's, on the
same numpy-seeded hidden states, unembedding and labels: both layouts,
chunks of 8, 16 and 2048 tokens (and a length the chunk must halve to
divide), with and without weights, values at rtol 1e-5 and gradients at
1e-5 (float32); the two layouts against each other (the reference's
property over 10 seeds too); ``full_logits``.  The masked position gets
exactly zero gradient."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

try:  # optional dev dependency (requirements-dev.txt)
    from hypothesis import given, settings, strategies as st
except ImportError:
    given = settings = st = None

from repro.models.losses import chunked_softmax_xent as jxent  # noqa: E402
from repro.models.losses import full_logits as jfull_logits  # noqa: E402
from repro_torch.models.losses import chunked_softmax_xent as txent  # noqa: E402,E501
from repro_torch.models.losses import full_logits  # noqa: E402

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
    """Also ``test_losses.py::test_layouts_match_naive``: each layout and
    chunk against the naive full-logits loss at rtol 1e-5."""
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


def _layouts(hidden, w_out, labels, weights=None, **kw):
    """(flat, batched) of the port and the JAX package's flat value."""
    t = [txent(torch.from_numpy(hidden), torch.from_numpy(w_out),
               torch.from_numpy(labels),
               weights=None if weights is None
               else torch.from_numpy(weights), layout=layout, **kw)
         for layout in ("flat", "batched")]
    want = jxent(jnp.asarray(hidden), jnp.asarray(w_out),
                 jnp.asarray(labels),
                 weights=None if weights is None else jnp.asarray(weights),
                 layout="flat", **kw)
    return float(t[0]), float(t[1]), float(want)


def test_layouts_match_each_other_with_weights():
    hidden, w_out, labels, weights = _data(1)
    a, b, want = _layouts(hidden, w_out, labels, weights)
    naive = _naive(torch.from_numpy(hidden), torch.from_numpy(w_out),
                   torch.from_numpy(labels), torch.from_numpy(weights))
    np.testing.assert_allclose(a, b, rtol=1e-5)
    np.testing.assert_allclose(a, float(naive), rtol=1e-5)
    np.testing.assert_allclose(a, want, rtol=1e-5)


if st is None:
    def test_layout_equivalence_property():
        pytest.importorskip("hypothesis")  # records the skip with reason
else:
    @given(st.integers(0, 2**31 - 1))
    @settings(max_examples=10, deadline=None)
    def test_layout_equivalence_property(seed):
        """The reference's property: chunks of 4 tokens, flat equal to
        batched (rtol 1e-5) on any seed, and to the JAX package's."""
        hidden, w_out, labels, _ = _data(seed, B=1, T=16, D=8, V=32)
        a, b, want = _layouts(hidden, w_out, labels, token_chunk=4)
        np.testing.assert_allclose(a, b, rtol=1e-5)
        np.testing.assert_allclose(a, want, rtol=1e-5)


def test_full_logits_shape():
    """The last position's logits, [2, 1, 64], equal to the JAX
    package's (float32, 1e-5)."""
    hidden, w_out, _, _ = _data(3)
    out = full_logits(torch.from_numpy(hidden[:, -1:]),
                      torch.from_numpy(w_out))
    assert out.shape == (2, 1, 64)
    want = jfull_logits(jnp.asarray(hidden[:, -1:]), jnp.asarray(w_out))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
