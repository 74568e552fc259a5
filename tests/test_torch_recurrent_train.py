"""Training the recurrent families in the port against the JAX package, on
the same seeded weights and tokens at the SMOKE size, float32:
``zamba2-2.7b`` (zamba_hybrid: mamba2 layers and one shared attention
block) and ``rwkv6-1.6b`` (uniform_rwkv).

- ``loss_and_grads`` against ``jax.value_and_grad(Model.loss)``: every
  leaf, shapes equal, in the chunked form of the recurrence (T a multiple
  of the chunk: zamba's SMOKE chunk is 8, rwkv's 4) and in the scan form
  (T = 13); the mixers' own leaves get nonzero gradients.
- The scan form's float32 rounding, held to the port's own float64
  gradient (the tolerance of the zamba scan case comes from it).
- One ``Trainer`` step on a ``DataPipeline`` batch against the
  reference's ``make_train_step`` on the same batch.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import smoke_pair  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train.train_step import make_train_step as jmake_step  # noqa: E402
from repro_torch.data.pipeline import DataPipeline  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import tree  # noqa: E402
from repro_torch.train.train_step import loss_and_grads  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

ZAMBA, RWKV = "zamba2-2.7b", "rwkv6-1.6b"
ARCHS = (ZAMBA, RWKV)
TOL = dict(atol=2e-5, rtol=2e-5)
# zamba's scan form (T not a multiple of the SSD chunk: the Python loop
# of ``decay_linear_attention_scan``).  Against the port's own float64
# gradient (``test_scan_form_error_is_float32_rounding``), the port's
# float32 gradient errs by at most 0.57 x TOL and the reference's by at
# most 2.26 x TOL (T = 12 and 13, measured on the CPU), so the two float32
# gradients may differ by their sum, 2.83 x TOL: 3 x TOL bounds it.  The
# serial recurrence through 2 superblocks of 2 mamba layers, and the
# shared attention block read after each, accumulate that rounding; the
# chunked form stays within TOL.
SCAN_TOL = dict(atol=6e-5, rtol=6e-5)


@pytest.fixture(scope="module")
def pairs():
    return {arch: smoke_pair(arch) for arch in ARCHS}


def _tokens(cfg, T: int) -> np.ndarray:
    return np.random.default_rng(4).integers(0, cfg.vocab_size, (2, T))


def _ref_grads(pair, tok):
    cfg, jm, jp, tm, tp = pair
    (loss, _), g = jax.value_and_grad(jm.loss, has_aux=True)(
        jp, {"tokens": jnp.asarray(tok, jnp.int32)})
    return float(loss), [np.asarray(x) for x in jax.tree.leaves(g)]


def _port_grads(model, params, tok):
    loss, _, g = loss_and_grads(model, params,
                                {"tokens": torch.from_numpy(tok)})
    return float(loss), g


@pytest.fixture(scope="module")
def grads(pairs):
    """(reference loss and leaves, port loss and tree) per (arch, T),
    computed once for the tests of this module."""
    cache = {}

    def get(arch, T):
        if (arch, T) not in cache:
            pair = pairs[arch]
            tok = _tokens(pair[0], T)
            cache[arch, T] = (_ref_grads(pair, tok),
                              _port_grads(pair[3], pair[4], tok))
        return cache[arch, T]

    return get


def _chunk(cfg) -> int:
    return cfg.ssm.chunk if cfg.ssm is not None else cfg.rwkv.chunk


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("T", [16, 32, 13])
def test_loss_and_grads_match_reference(pairs, grads, arch, T):
    cfg = pairs[arch][0]
    chunked = T % _chunk(cfg) == 0
    assert chunked == (T != 13)
    (jloss, want), (loss, g) = grads(arch, T)
    tol = TOL if chunked or arch == RWKV else SCAN_TOL
    np.testing.assert_allclose(loss, jloss, **TOL)
    got = [x.numpy() for x in tree.flatten(g)[0]]
    assert [a.shape for a in got] == [b.shape for b in want]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **tol)


@pytest.mark.parametrize("arch,leaves", [
    (ZAMBA, [("super", "mixer", "a_log"), ("super", "mixer", "d_skip"),
             ("super", "mixer", "dt_bias"), ("super", "mixer", "conv_w"),
             ("super", "mixer", "conv_b"), ("shared_attn", "attn", "wq"),
             ("shared_attn", "attn", "wk"), ("shared_attn", "mlp", "wo")]),
    (RWKV, [("layers", "rwkv", "w0"), ("layers", "rwkv", "w_lora_a"),
            ("layers", "rwkv", "w_lora_b"), ("layers", "rwkv", "u_bonus"),
            ("layers", "rwkv", "mix_w"), ("layers", "rwkv", "ln_x")]),
])
@pytest.mark.parametrize("T", [16, 13])
def test_recurrent_leaves_get_gradients(grads, arch, leaves, T):
    """The decay, skip, conv and bonus leaves, and zamba's shared block,
    are reached by the gradient in both forms (every layer of a stacked
    leaf: a recurrence that dropped a layer's state would zero it)."""
    g = grads(arch, T)[1][1]
    for path in leaves:
        x = g
        for key in path:
            x = x[key]
        assert bool(torch.isfinite(x).all()), path
        lead = {"super": 2, "layers": 1}.get(path[0], 0)  # layer axes
        per_layer = x.reshape(int(np.prod(x.shape[:lead])), -1)
        assert bool((per_layer.abs().amax(dim=-1) > 0).all()), path


def _f64_grads(pair, tok, monkeypatch):
    """The port's gradient in float64: the model at ``dtype="float64"``,
    the weights cast, and ``Tensor.float`` (the port's "at least f32"
    casts) leaving float64 as it is.  The scan form's f32 state then
    promotes to float64 at its first update."""
    cfg, _, _, tm, tp = pair
    model = build_model(dataclasses.replace(tm.cfg, dtype="float64"),
                        device="cpu")
    params = tree.map_leaves(
        lambda x: x.double() if x.is_floating_point() else x, tp)
    as_f32 = torch.Tensor.float
    monkeypatch.setattr(
        torch.Tensor, "float",
        lambda self, *a, **k: (self if self.dtype == torch.float64
                               else as_f32(self, *a, **k)))
    _, g = _port_grads(model, params, tok)
    monkeypatch.undo()
    leaves = tree.flatten(g)[0]
    assert all(x.dtype == torch.float64 for x in leaves)
    return [x.numpy() for x in leaves]


@pytest.mark.parametrize("T", [12, 13])
def test_scan_form_error_is_float32_rounding(pairs, grads, monkeypatch, T):
    """zamba's scan form: the port's float32 gradient is within TOL of its
    float64 gradient, and the reference's float32 gradient within
    SCAN_TOL of it; so the port computes the reference's function and the
    gap between the two float32 results is rounding (the bound
    SCAN_TOL states)."""
    pair = pairs[ZAMBA]
    tok = _tokens(pair[0], T)
    assert T % _chunk(pair[0])
    (_, want), (_, g) = grads(ZAMBA, T)
    truth = _f64_grads(pair, tok, monkeypatch)
    got = [x.numpy() for x in tree.flatten(g)[0]]
    for a, b, c in zip(got, want, truth):
        np.testing.assert_allclose(a, c, **TOL)
        np.testing.assert_allclose(b, c, **SCAN_TOL)
        np.testing.assert_allclose(a, b, **SCAN_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_step_matches_reference(pairs, tmp_path, arch):
    """One ``Trainer`` step on the first ``DataPipeline`` batch (chunked
    form: 16 tokens) against the reference's ``make_train_step`` on that
    batch: loss, grad norm and every parameter after the step.  lr 1e-5,
    as ``test_torch_train.py::test_train_step_matches_jax``: Adam's first
    step is sign-like, so an element whose gradient sits at rounding
    level may flip; 2e-5 bounds such an element, and the step must have
    moved the parameters by about lr."""
    cfg, jm, jp, tm, tp = pairs[arch]
    kw = dict(lr=1e-5, warmup_steps=1, clip_norm=1.0)
    jo, to = jopt.AdamW(jopt.OptConfig(**kw)), topt.AdamW(topt.OptConfig(**kw))
    tr = Trainer(tm, to, TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=100,
                                       log_every=1, async_checkpoint=False))
    tr.params, tr.opt_state = tp, to.init(tp)
    seen = []
    pipe = DataPipeline(batch=2, seq_len=16, vocab=cfg.vocab_size,
                        nproducers=2, seed=5)

    def feed():
        for b in pipe:
            seen.append(b)
            yield b

    try:
        hist = tr.fit(feed(), steps=1)
    finally:
        pipe.close()
    jnew, _, jmet = jax.jit(jmake_step(jm, jo))(
        jp, jo.init(jp), {"tokens": jnp.asarray(seen[0]["tokens"])})
    np.testing.assert_allclose(hist[0]["loss"], float(jmet["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(hist[0]["grad_norm"], float(jmet["grad_norm"]),
                               rtol=1e-5)
    moved = 0.0
    for new, old, want in zip(tree.flatten(tr.params)[0],
                              tree.flatten(tp)[0], jax.tree.leaves(jnew)):
        np.testing.assert_allclose(new.numpy(), np.asarray(want), atol=2e-5,
                                   rtol=0)
        moved = max(moved, float((new - old).abs().max()))
    assert moved > 0.5 * kw["lr"]
