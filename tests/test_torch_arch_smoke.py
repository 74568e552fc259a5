"""Per-architecture smoke tests of the port, the counterpart of
``tests/test_arch_smoke.py``: for every family the port builds, the
SMOKE config at its own dtype through one loss and gradient, and one
prefill + 3 decode steps, with inputs from ``models/inputs.py``
(finite, shaped, in range); the parameter tree's shapes and its
logical axes equal to the reference's; and, at float32 on the same weights, logits within 2e-5 of
the reference's (through the image or frame source where the family
has one).  The port builds every family of the registry."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import smoke_pair  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models.layers import unembed_matrix as j_unembed  # noqa: E402
from repro.models.model import build_model as j_build  # noqa: E402
from repro_torch.configs import get_smoke_config, list_archs  # noqa: E402
from repro_torch.models.config import ShapeConfig  # noqa: E402
from repro_torch.models.inputs import (concrete, decode_specs,  # noqa: E402
                                       prefill_specs, train_batch_specs)
from repro_torch.models.layers import unembed_matrix  # noqa: E402
from repro_torch.models.losses import full_logits  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.train import tree  # noqa: E402
from repro_torch.train.train_step import loss_and_grads  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

SMOKE_SHAPE = ShapeConfig("smoke", "train", seq_len=16, global_batch=2)
ARCHS = list_archs()


@pytest.fixture(scope="module")
def built():
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg = get_smoke_config(arch)
            model = build_model(cfg, device="cpu")
            params = model.init(torch.Generator().manual_seed(0))
            cache[arch] = (cfg, model, params)
        return cache[arch]

    return get


def _finite(tree_) -> bool:
    return all(bool(torch.isfinite(x).all()) for x in tree.flatten(tree_)[0]
               if x.is_floating_point())


def test_every_family_but_the_recurrent_ones_is_built():
    """Every family is built now, the recurrent ones included (the name
    is the test's from before they were ported)."""
    families = {build_model(get_smoke_config(a), device="cpu")._structure()
                for a in ARCHS}
    assert families == {"uniform_attn", "uniform_moe", "gemma_local_global",
                        "vlm_cross", "enc_dec", "zamba_hybrid",
                        "uniform_rwkv"}
    assert {"zamba2-2.7b", "rwkv6-1.6b"} <= set(ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss(arch, built):
    cfg, model, params = built(arch)
    batch = concrete(train_batch_specs(cfg, SMOKE_SHAPE),
                     vocab=cfg.vocab_size)
    with torch.no_grad():
        loss, metrics = model.loss(params, batch)
    assert loss.shape == ()
    assert bool(torch.isfinite(loss)), f"{arch}: loss={loss}"
    assert float(loss) > 0
    assert float(metrics["xent"]) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_grads_finite(arch, built):
    cfg, model, params = built(arch)
    batch = concrete(train_batch_specs(cfg, SMOKE_SHAPE),
                     torch.Generator().manual_seed(1), vocab=cfg.vocab_size)
    loss, _, grads = loss_and_grads(model, params, batch)
    assert bool(torch.isfinite(loss))
    assert _finite(grads), f"{arch}: non-finite grads"
    assert float(grads["embed"]["table"].abs().max()) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_reference(arch, built):
    cfg, model, params = built(arch)
    jm = j_build(j_smoke(arch))
    want = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    got = tree.flatten(params)[0]
    leaves = jax.tree.leaves(want)
    assert [tuple(a.shape) for a in got] == [b.shape for b in leaves]
    assert all(a.dtype == cfg.compute_dtype for a in got)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_tree_matches(arch, built):
    """One ``Axes`` leaf per parameter leaf, in the same tree, each of
    the leaf's rank; the axis names equal the JAX package's."""
    from repro.parallel.sharding import Axes as JAxes
    from repro_torch.parallel.sharding import Axes
    cfg, model, params = built(arch)
    leaves, spec = tree.flatten(params)
    axes, aspec = tree.flatten(model.param_axes(),
                               lambda x: isinstance(x, Axes))
    assert spec == aspec and len(leaves) == len(axes)
    for p, a in zip(leaves, axes):
        assert isinstance(a, Axes)
        assert len(a.names) == p.dim(), f"{arch}: {a} vs {tuple(p.shape)}"
    want = jax.tree.leaves(j_build(j_smoke(arch)).param_axes(),
                           is_leaf=lambda x: isinstance(x, JAxes))
    assert [tuple(a.names) for a in axes] == [tuple(a.names) for a in want]


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode(arch, built):
    cfg, model, params = built(arch)
    B, T, max_len = 2, 8, 16
    shape = ShapeConfig("smoke", "prefill", seq_len=T, global_batch=B)
    inp = concrete(prefill_specs(cfg, shape),
                   torch.Generator().manual_seed(1), vocab=cfg.vocab_size)
    dspec = decode_specs(cfg, dataclasses.replace(shape, seq_len=max_len),
                         model)
    with torch.no_grad():
        tok, caches = model.prefill(params, inp["tokens"], max_len,
                                    extras=inp.get("extras"))
        assert tok.shape == (B,)
        assert _finite(caches), f"{arch}: non-finite cache after prefill"
        assert [t.shape for t in tree.flatten(caches)[0]] == \
            [t.shape for t in tree.flatten(dspec["caches"])[0]]
        for i in range(3):
            pos = torch.full(tuple(dspec["pos"].shape), T + i,
                             dtype=torch.int32)
            tok2, caches = model.decode_step(params, caches, tok[:, None],
                                             pos)
            assert tok2.shape == (B,)
            assert bool(((tok2 >= 0) & (tok2 < cfg.vocab_size)).all())
            tok = tok2


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_match_reference(arch):
    """The same weights at float32: logits within 2e-5 of the JAX
    package's, through the family's image or frame source."""
    cfg, jm, jp, tm, tp = smoke_pair(arch)
    shape = ShapeConfig("smoke", "prefill", seq_len=12, global_batch=2)
    inp = concrete(prefill_specs(tm.cfg, shape),
                   torch.Generator().manual_seed(2), vocab=cfg.vocab_size)
    src = inp.get("extras")
    jh, _, _ = jm.forward(jp, jnp.asarray(inp["tokens"].numpy()),
                          extras=None if src is None
                          else jnp.asarray(src.numpy()))
    with torch.no_grad():
        th, _, _ = tm.forward(tp, inp["tokens"], extras=src)
    w = np.asarray(j_unembed(jp["embed"], cfg))
    np.testing.assert_allclose(th.numpy() @ w, np.asarray(jh) @ w,
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen3-14b", "stablelm-3b",
                                  "rwkv6-1.6b", "zamba2-2.7b"])
def test_decode_matches_forward(arch, built):
    """Greedy decode from a filled cache agrees with the teacher-forced
    forward on the same prefix (incremental == batch computation)."""
    cfg, model, params = built(arch)
    B, T = 1, 12
    tokens = torch.randint(0, cfg.vocab_size, (B, T),
                           generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        hidden, _, _ = model.forward(params, tokens)
        w = unembed_matrix(params["embed"], cfg).to(cfg.compute_dtype)
        want = torch.argmax(full_logits(hidden, w), dim=-1)     # [B, T]
        half = T // 2
        tok, caches = model.prefill(params, tokens[:, :half], T + 4)
        assert int(tok[0]) == int(want[0, half - 1])
        for i in range(half, T):
            tok, caches = model.decode_step(params, caches,
                                            tokens[:, i:i + 1], i)
            assert int(tok[0]) == int(want[0, i]), f"{arch}: position {i}"


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "whisper-tiny",
                                  "zamba2-2.7b", "rwkv6-1.6b"])
def test_input_specs_match_reference(arch):
    """Shapes and dtypes of every spec equal the JAX package's
    ``inputs`` at the same cell; nothing is allocated for a spec."""
    from repro.models import inputs as jinputs
    from repro.models.config import ShapeConfig as JShape
    cfg, jcfg = get_smoke_config(arch), j_smoke(arch)
    jshape = JShape("smoke", "train", seq_len=16, global_batch=2)
    for ours, theirs in ((train_batch_specs, jinputs.train_batch_specs),
                         (prefill_specs, jinputs.prefill_specs)):
        got, want = ours(cfg, SMOKE_SHAPE), theirs(jcfg, jshape)
        assert sorted(got) == sorted(want)
        for k in got:
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == want[k].shape
            assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
    jm = j_build(jcfg)
    got = decode_specs(cfg, SMOKE_SHAPE, build_model(cfg, device="cpu"))
    want = jinputs.decode_specs(jcfg, jshape, jm)
    assert [tuple(t.shape) for t in tree.flatten(got["caches"])[0]] == \
        [t.shape for t in jax.tree.leaves(want["caches"])]
    assert tuple(got["tokens"].shape) == want["tokens"].shape
