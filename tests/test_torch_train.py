"""The port's training path on the CPU against the JAX package's, on the
same numpy-seeded inputs and converted weights (SMOKE config, float32
where values are compared): ``flash_attention_trainable``'s gradients
(1e-4, the reference's own gradient tolerance), ``Model.loss`` and its
gradients under each remat policy (loss rtol 1e-5, gradients 1e-4),
``AdamW.update`` on the same gradients in float32 and int8 states, one
full train step, microbatching, checkpoints (bf16 included),
``synth_batch`` (bit for bit) and the pipeline, and the trainer's
loss, restart, straggler and telemetry contracts."""
import dataclasses
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import smoke_pair  # noqa: E402
from repro.data.pipeline import synth_batch as jsynth  # noqa: E402
from repro.kernels.flash_attention import (  # noqa: E402
    flash_attention_trainable as jfa_trainable)
from repro.train import optimizer as jopt  # noqa: E402
from repro.train.train_step import make_train_step as jmake_step  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data.pipeline import DataPipeline, synth_batch  # noqa: E402
from repro_torch.kernels import flash_attention as fa_mod  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train as launcher  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.train import checkpoint as ckpt_lib  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import tree  # noqa: E402
from repro_torch.train.train_step import (  # noqa: E402
    loss_and_grads, make_decode_step, make_prefill, make_train_step)
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

jax.config.update("jax_platform_name", "cpu")


@pytest.fixture(scope="module")
def pair():
    return smoke_pair(seed=3)


def _tokens(seed, B, T, vocab):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, size=(B, T)).astype(np.int32)


def _np_leaves(t):
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(t)]


def _t_leaves(t):
    return [x.detach().float().numpy() for x in tree.flatten(t)[0]]


# ---------------------------------------------------------------------------
# flash_attention_trainable
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,T,H,Hkv,hd,kw", [
    (1, 128, 2, 2, 64, {}),                                  # test_kernels
    (2, 128, 4, 2, 32, dict(window=48, softcap=30.0)),
])
def test_flash_trainable_grads_match_jax(B, T, H, Hkv, hd, kw):
    rng = np.random.default_rng(12)
    q = rng.normal(size=(B, T, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, T, Hkv, hd)).astype(np.float32)
    v = rng.normal(size=(B, T, Hkv, hd)).astype(np.float32)
    g = rng.normal(size=(B, T, H, hd)).astype(np.float32)
    window, softcap = kw.get("window", 0), kw.get("softcap", 0.0)

    def jf(q, k, v):
        out = jfa_trainable(q, k, v, True, window, softcap, 128, 128, True)
        return jnp.sum(out * jnp.asarray(g)), out

    (_, jout), jg = jax.value_and_grad(jf, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = ops.flash_attention_trainable(tq, tk, tv, causal=True, **kw)
    tg = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=2e-5, rtol=2e-5)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=1e-4)


# ---------------------------------------------------------------------------
# Model.loss
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("remat", ["nothing", "dots", "none"])
def test_model_loss_and_grads_match_jax(pair, remat):
    jcfg, jm, jp, tm, tp = pair
    tok = _tokens(4, 2, 16, jcfg.vocab_size)
    (jloss, jmet), jg = jax.value_and_grad(jm.loss, has_aux=True)(
        jp, {"tokens": jnp.asarray(tok)})
    model = build_model(tm.cfg, remat_policy=remat, device="cpu")
    loss, metrics, grads = loss_and_grads(model, tp,
                                          {"tokens": torch.from_numpy(tok)})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["xent"]), float(jmet["xent"]),
                               rtol=1e-5)
    assert float(metrics["aux"]) == float(jmet["aux"]) == 0.0
    got, want = _t_leaves(grads), _np_leaves(jg)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("remat,per_layer", [("nothing", 2), ("dots", 2),
                                             ("none", 1)])
def test_remat_reruns_the_attention_forward(monkeypatch, remat, per_layer):
    """A recomputing checkpoint re-runs each layer's flash forward in the
    backward: the chip run counts 2 x layers launches per step under
    "nothing", and 1 x layers without remat."""
    calls = [0]
    plain = fa_mod.flash_attention_fwd        # the trainable forward's call

    def counted(*a, **kw):
        calls[0] += 1
        return plain(*a, **kw)

    monkeypatch.setattr(fa_mod, "flash_attention_fwd", counted)
    cfg = dataclasses.replace(get_smoke_config("smollm-135m"),
                              dtype="float32")
    model = build_model(cfg, remat_policy=remat, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    tok = torch.from_numpy(_tokens(5, 2, 16, cfg.vocab_size))
    loss_and_grads(model, params, {"tokens": tok})
    assert calls[0] == per_layer * cfg.num_layers
    calls[0] = 0
    with torch.no_grad():
        model.loss(params, {"tokens": tok})
    assert calls[0] == cfg.num_layers


def test_unknown_remat_policy_is_refused():
    with pytest.raises(ValueError, match="remat_policy"):
        build_model(get_smoke_config("smollm-135m"), remat_policy="all",
                    device="cpu")


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def _opt_trees(seed):
    rng = np.random.default_rng(seed)
    shapes = {"w": (8, 16), "b": (16,), "e": {"t": (4, 8, 3), "n": (3,)}}

    def draw(s):
        if isinstance(s, dict):
            return {k: draw(v) for k, v in s.items()}
        return rng.normal(size=s).astype(np.float32)

    return draw(shapes), [draw(shapes) for _ in range(3)]


def _to_torch(t):
    return tree.map_leaves(lambda x: torch.from_numpy(np.array(x)), t)


@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
def test_adamw_update_matches_jax(state_dtype):
    """Three updates from the same gradients (clipping active, warmup
    then cosine)."""
    params, grads = _opt_trees(6)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=1.0,
              state_dtype=state_dtype)
    jo, to = jopt.AdamW(jopt.OptConfig(**kw)), topt.AdamW(topt.OptConfig(**kw))
    jp = jax.tree.map(jnp.asarray, params)
    js = jo.init(jp)
    tp = _to_torch(params)
    ts = to.init(tp)
    for g in grads:
        jp, js, jm = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp2, ts, tm = to.update(_to_torch(g), ts, tp)
        for a, b in zip(tree.flatten(tp2)[0], tree.flatten(tp)[0]):
            assert a is not b                  # functional: new tensors
        tp = tp2
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
    assert int(ts["step"]) == int(js["step"]) == 3
    for a, b in zip(_t_leaves(tp), _np_leaves(jp)):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-5)
    if state_dtype == "float32":
        for key in ("m", "v"):
            for a, b in zip(_t_leaves(ts[key]), _np_leaves(js[key])):
                np.testing.assert_allclose(a, b, atol=1e-7, rtol=1e-5)
    else:
        is_leaf = (lambda x: isinstance(x, dict) and "q" in x)
        for key in ("m", "v"):
            tl = tree.flatten(ts[key], is_leaf)[0]
            jl = jax.tree.leaves(js[key], is_leaf=is_leaf)
            for a, b in zip(tl, jl):
                assert a["q"].dtype == torch.int8
                deq_t = topt._dequantize(a).numpy()
                deq_j = np.asarray(jopt._dequantize(b))
                np.testing.assert_allclose(a["scale"].numpy(),
                                           np.asarray(b["scale"]),
                                           rtol=1e-6)
                step = np.asarray(b["scale"])       # one quantization step
                assert np.all(np.abs(deq_t - deq_j) <= step * 1.001)


def test_adamw_does_not_write_its_arguments():
    params, grads = _opt_trees(7)
    opt = topt.AdamW(topt.OptConfig(lr=1e-2, warmup_steps=1))
    tp, tg = _to_torch(params), _to_torch(grads[0])
    state = opt.init(tp)
    before = [x.clone() for x in tree.flatten((tp, tg, state))[0]]
    opt.update(tg, state, tp)
    for a, b in zip(tree.flatten((tp, tg, state))[0], before):
        assert torch.equal(a, b)


@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
def test_adamw_row_blocks_give_the_same_bits(monkeypatch, state_dtype):
    """A matrix leaf larger than ``_CHUNK_ELEMS`` is updated a block of
    rows at a time (float32 state): the same bits as the whole leaf."""
    params, grads = _opt_trees(5)
    opt = topt.AdamW(topt.OptConfig(lr=1e-2, warmup_steps=1,
                                    state_dtype=state_dtype))
    tp = _to_torch(params)
    state = opt.init(tp)
    whole = opt.update(_to_torch(grads[0]), state, tp)
    monkeypatch.setattr(topt, "_CHUNK_ELEMS", 7)
    assert max(x.numel() for x in tree.flatten(tp)[0]) > 7
    blocks = opt.update(_to_torch(grads[0]), state, tp)
    for a, b in zip(tree.flatten(whole[:2])[0], tree.flatten(blocks[:2])[0]):
        assert a.shape == b.shape and torch.equal(a, b)


def test_schedule_and_quantize_match_jax():
    kw = dict(lr=2e-3, warmup_steps=3, total_steps=10)
    jo, to = jopt.AdamW(jopt.OptConfig(**kw)), topt.AdamW(topt.OptConfig(**kw))
    for s in range(13):
        np.testing.assert_allclose(
            float(to.schedule(torch.tensor(s, dtype=torch.int32))),
            float(jo.schedule(jnp.int32(s))), rtol=1e-6)
    # Ties round half to even in both (absmax 127 -> scale 1).
    x = np.array([[127.0, 0.5, 1.5, 2.5, -2.5, -0.5, 3.49]], np.float32)
    tq, jq = topt._quantize(torch.from_numpy(x)), jopt._quantize(x)
    np.testing.assert_array_equal(tq["q"].numpy(), np.asarray(jq["q"]))
    assert tq["q"].numpy().tolist() == [[127, 0, 2, 2, -2, 0, 3]]
    s = topt._quantize(torch.tensor(3.0))
    assert s["q"].dim() == 0 and float(topt._dequantize(s)) == 3.0


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------
def test_train_step_matches_jax(pair):
    """One full step: loss, grad norm, lr and the new parameters (lr 1e-5:
    Adam's first step is sign-like, so a gradient at rounding level may
    flip an element's update; the tolerance bounds two such steps)."""
    jcfg, jm, jp, tm, tp = pair
    kw = dict(lr=1e-5, warmup_steps=1, clip_norm=1.0)
    jo, to = jopt.AdamW(jopt.OptConfig(**kw)), topt.AdamW(topt.OptConfig(**kw))
    tok = _tokens(8, 2, 16, jcfg.vocab_size)
    jnp_, _, jmet = jax.jit(jmake_step(jm, jo))(jp, jo.init(jp),
                                                {"tokens": jnp.asarray(tok)})
    tnp, tstate, tmet = make_train_step(tm, to)(
        tp, to.init(tp), {"tokens": torch.from_numpy(tok)})
    for key in ("loss", "grad_norm", "lr", "xent"):
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                   rtol=1e-5)
    assert int(tstate["step"]) == 1
    for a, b in zip(_t_leaves(tnp), _np_leaves(jnp_)):
        np.testing.assert_allclose(a, b, atol=2.5e-5, rtol=0)


def test_microbatched_matches_monolithic():
    cfg = dataclasses.replace(get_smoke_config("smollm-135m"),
                              dtype="float32")
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    opt = topt.AdamW(topt.OptConfig(lr=1e-3, clip_norm=1e9))
    batch = {"tokens": torch.from_numpy(_tokens(1, 4, 16, cfg.vocab_size))}
    p1, o1, m1 = make_train_step(model, opt, 1)(params, opt.init(params),
                                                batch)
    p4, o4, m4 = make_train_step(model, opt, 4)(params, opt.init(params),
                                                batch)
    assert np.isclose(float(m1["loss"]), float(m4["loss"]), rtol=1e-4)
    for a, b in zip(_t_leaves(p1), _t_leaves(p4)):
        np.testing.assert_allclose(a, b, atol=5e-5, rtol=5e-4)
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(model, opt, 3)(params, opt.init(params), batch)


def test_decode_and_prefill_steps_wrap_the_model():
    cfg = dataclasses.replace(get_smoke_config("smollm-135m"),
                              dtype="float32")
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(1))
    tok = torch.from_numpy(_tokens(2, 2, 6, cfg.vocab_size))
    nxt, cache = make_prefill(model, 16)(params, tok)
    want_nxt, want_cache = model.prefill(params, tok, 16)
    assert torch.equal(nxt, want_nxt)
    assert torch.equal(cache["k"], want_cache["k"])
    step = make_decode_step(model)
    a, _ = step(params, cache, nxt[:, None], 6)
    b, _ = model.decode_step(params, want_cache, want_nxt[:, None], 6)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# checkpoint
# ---------------------------------------------------------------------------
def _state():
    g = torch.Generator().manual_seed(0)
    return ({"a": torch.arange(12.0).reshape(3, 4),
             "w": torch.randn(5, 3, generator=g).to(torch.bfloat16)},
            {"step": torch.tensor(7, dtype=torch.int32),
             "m": {"q": torch.tensor([[1, -127, 5]], dtype=torch.int8),
                   "scale": torch.tensor([[0.5]])}})


def test_checkpoint_roundtrip_with_bf16(tmp_path):
    """``test_trainer.py::test_checkpoint_roundtrip``, with a bf16 leaf
    beside the float32, int32 and int8 ones: every leaf comes back equal,
    in its dtype, at its step."""
    state = _state()
    d = ckpt_lib.save(tmp_path, 7, state)
    manifest = json.loads((d / "manifest.json").read_text())
    dtypes = sorted(e["dtype"] for e in manifest["leaves"])
    assert dtypes == ["bfloat16", "float32", "float32", "int32", "int8"]
    stored = [np.load(d / e["name"]).dtype for e in manifest["leaves"]
              if e["dtype"] == "bfloat16"]
    assert stored == [np.int16]              # the raw bits, no ml_dtypes
    step, restored = ckpt_lib.restore(tmp_path, state)
    assert step == 7
    assert isinstance(restored, tuple)
    for x, y in zip(tree.flatten(state)[0], tree.flatten(restored)[0]):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_checkpoint_gc_and_latest(tmp_path):
    state = {"a": torch.zeros(2)}
    for s in (1, 2, 3, 4):
        ckpt_lib.save(tmp_path, s, state, keep=2)
    assert ckpt_lib.latest_step(tmp_path) == 4
    steps = sorted(int(p.name.split("_")[1])
                   for p in tmp_path.glob("step_*"))
    assert steps == [3, 4]
    assert ckpt_lib.latest_step(tmp_path / "missing") is None
    with pytest.raises(FileNotFoundError):
        ckpt_lib.restore(tmp_path / "missing", state)


def test_checkpoint_detects_corruption(tmp_path):
    state = {"a": torch.arange(4.0),
             "b": torch.ones(3, dtype=torch.bfloat16)}
    d = ckpt_lib.save(tmp_path, 1, state)
    for leaf in sorted(d.glob("leaf_*.npy")):
        arr = np.load(leaf)
        arr[0] += 1
        np.save(leaf, arr)
        with pytest.raises(IOError, match="CRC"):
            ckpt_lib.restore(tmp_path, state)
        arr[0] -= 1
        np.save(leaf, arr)
    ckpt_lib.restore(tmp_path, state)


def test_checkpoint_shape_and_structure_mismatch(tmp_path):
    """``test_trainer.py::test_checkpoint_shape_mismatch``, and a tree of
    another structure."""
    ckpt_lib.save(tmp_path, 1, {"a": torch.zeros(4)})
    with pytest.raises(ValueError, match="shape"):
        ckpt_lib.restore(tmp_path, {"a": torch.zeros(5)})
    with pytest.raises(ValueError, match="leaves"):
        ckpt_lib.restore(tmp_path, {"a": torch.zeros(4),
                                    "b": torch.zeros(1)})


def test_async_checkpointer_saves_latest(tmp_path):
    ck = ckpt_lib.AsyncCheckpointer(tmp_path, keep=2, poll_s=0.001)
    for s in range(5):
        ck.publish(s, {"x": torch.full((2,), float(s))})
    ck.close()
    assert ckpt_lib.latest_step(tmp_path) == 4    # freshest always lands
    _, restored = ckpt_lib.restore(tmp_path, {"x": torch.zeros(2)})
    assert torch.equal(restored["x"], torch.full((2,), 4.0))
    assert ck.saved_steps[-1] == 4


def test_async_checkpointer_publish_between_read_and_save(tmp_path):
    """A publish that lands just after the writer's read is saved too:
    the writer records the snapshot it read, not the cell's newest."""
    from repro_torch.core import nbw

    class Cell(nbw.HostNBW):
        hook = None

        def try_read(self):
            status, value = super().try_read()
            if status == nbw.OK and value is not None and self.hook:
                hook, Cell.hook = Cell.hook, None
                hook()
            return status, value

    ck = ckpt_lib.AsyncCheckpointer(tmp_path, keep=3, poll_s=0.001)
    ck._cell = Cell(depth=2)
    Cell.hook = lambda: ck.publish(2, {"x": torch.full((2,), 2.0)})
    ck.publish(1, {"x": torch.full((2,), 1.0)})
    ck.close()
    assert Cell.hook is None                      # the interleaving happened
    assert ck.saved_steps == [1, 2]
    assert ckpt_lib.latest_step(tmp_path) == 2
    _, restored = ckpt_lib.restore(tmp_path, {"x": torch.zeros(2)})
    assert torch.equal(restored["x"], torch.full((2,), 2.0))


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("args", [(0, 1, 2, 4, 8, 100),
                                  (3, 0, 0, 2, 16, 49152),
                                  (5, 2, 9, 1, 4, 256),
                                  (0, 1, 2, 4, 8, 100, (24, 64)),
                                  (7, 3, 1, 2, 448, 51865, (1500, 384))])
def test_synth_batch_equals_jax(args):
    """Bit for bit the JAX package's batch; and
    ``test_trainer.py::test_synth_batch_deterministic``: the same
    arguments draw the same tokens again, the next step other ones."""
    a = synth_batch(*args)
    b = jsynth(*args)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(synth_batch(*args)["tokens"], a["tokens"])
    step = (*args[:2], args[2] + 1, *args[3:])
    assert not np.array_equal(synth_batch(*step)["tokens"], a["tokens"])


def test_pipeline_carries_extras():
    """``extras_shape``: every batch is ``synth_batch``'s with the source
    under ``"extras"``, as the reference pipeline stores it."""
    index = {synth_batch(2, p, s, 2, 8, 1000)["tokens"].tobytes(): (p, s)
             for p in range(2) for s in range(16)}
    pipe = DataPipeline(batch=2, seq_len=8, vocab=1000, nproducers=2,
                        seed=2, depth=4, extras_shape=(3, 5))
    try:
        got = [pipe.get() for _ in range(6)]
    finally:
        pipe.close()
    for b in got:
        want = jsynth(2, *index[b["tokens"].tobytes()], 2, 8, 1000, (3, 5))
        assert b.keys() == want.keys() == {"tokens", "extras"}
        np.testing.assert_array_equal(b["extras"], want["extras"])


def test_pipeline_delivers_every_batch_once_in_producer_order():
    """``test_trainer.py::test_pipeline_delivers_unique_batches``: [2, 8]
    batches, each delivered once, in each producer's order."""
    n_prod = 3
    index = {synth_batch(0, p, s, 2, 8, 1000)["tokens"].tobytes(): (p, s)
             for p in range(n_prod) for s in range(64)}
    pipe = DataPipeline(batch=2, seq_len=8, vocab=1000, nproducers=n_prod,
                        seed=0, depth=4)
    try:
        batches = [pipe.get()["tokens"] for _ in range(24)]
    finally:
        pipe.close()
    assert all(b.shape == (2, 8) for b in batches)
    got = [index[b.tobytes()] for b in batches]
    assert len(set(got)) == 24                 # exactly once
    for p in range(n_prod):                    # FIFO per producer
        seqs = [s for q, s in got if q == p]
        assert seqs == list(range(len(seqs)))


# ---------------------------------------------------------------------------
# trainer
# ---------------------------------------------------------------------------
@pytest.fixture()
def tiny():
    cfg = get_smoke_config("smollm-135m")
    model = build_model(cfg, device="cpu")
    opt = topt.AdamW(topt.OptConfig(lr=1e-3, warmup_steps=2,
                                    total_steps=100))
    return cfg, model, opt


def _stream(cfg, slow_at=None):
    s = 0
    while True:
        if s == slow_at:
            time.sleep(1.0)          # one stalled data feed
        yield synth_batch(0, 0, s, 2, 16, cfg.vocab_size)
        s += 1


def test_trainer_loss_decreases(tiny, tmp_path):
    cfg, model, opt = tiny
    tc = TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=1000,
                       log_every=5, async_checkpoint=False)
    tr = Trainer(model, opt, tc)
    pipe = DataPipeline(batch=2, seq_len=16, vocab=cfg.vocab_size,
                        nproducers=2, seed=0)
    try:
        hist = tr.fit(pipe, steps=30)
    finally:
        pipe.close()
    assert [h["step"] for h in hist] == [5, 10, 15, 20, 25, 30]
    assert hist[-1]["loss"] < hist[0]["loss"], hist


def test_trainer_without_checkpoints_writes_none(tiny, tmp_path):
    """``ckpt_every=0`` (the launcher's ``--ckpt-every 0``): no periodic
    checkpoint and no final one at ``close``."""
    cfg, model, opt = tiny
    tc = TrainerConfig(ckpt_dir=str(tmp_path / "none"), ckpt_every=0)
    tr = Trainer(model, opt, tc)
    tr.fit(_stream(cfg), steps=3)
    tr.close()
    assert tr.step == 3 and tr.ckpt is None
    assert not (tmp_path / "none").exists()


def test_trainer_checkpoint_restart_exact(tiny, tmp_path):
    """A restart from a checkpoint reproduces the uninterrupted run (same
    data through the deterministic stream, same parameters)."""
    cfg, model, opt = tiny
    tc = TrainerConfig(ckpt_dir=str(tmp_path / "a"), ckpt_every=5,
                       async_checkpoint=False)
    tr = Trainer(model, opt, tc, seed=7)
    tr.fit(_stream(cfg), steps=10)
    p_ref = _t_leaves(tr.params)

    tc2 = TrainerConfig(ckpt_dir=str(tmp_path / "b"), ckpt_every=5,
                        async_checkpoint=False)
    tr2 = Trainer(model, opt, tc2, seed=7)
    tr2.fit(_stream(cfg), steps=5)
    del tr2
    tr3 = Trainer(model, opt, tc2, seed=999, resume=True)
    assert tr3.step == 5
    gen = _stream(cfg)
    for _ in range(5):           # replay the consumed prefix
        next(gen)
    tr3.fit(gen, steps=5)
    for a, b in zip(p_ref, _t_leaves(tr3.params)):
        np.testing.assert_allclose(a, b, atol=1e-6)


def test_trainer_async_checkpoint_publishes_and_resumes(tiny, tmp_path):
    cfg, model, opt = tiny
    tc = TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=3)
    tr = Trainer(model, opt, tc, generator=torch.Generator().manual_seed(2))
    tr.fit(_stream(cfg), steps=6)
    tr.close()                               # publishes step 6 and drains
    assert ckpt_lib.latest_step(tmp_path) == 6
    assert 6 in tr.ckpt.saved_steps
    again = Trainer(model, opt, dataclasses.replace(tc, async_checkpoint=False),
                    resume=True)
    assert again.step == 6
    for a, b in zip(_t_leaves((tr.params, tr.opt_state)),
                    _t_leaves((again.params, again.opt_state))):
        np.testing.assert_array_equal(a, b)


def test_async_snapshot_is_never_written_again(tiny, tmp_path,
                                               monkeypatch):
    """The checkpointer is handed references, not copies: a writer that
    saves step 3 only after steps 4-6 ran must still write step 3's
    values (the optimizer and step return new tensors)."""
    cfg, model, opt = tiny
    real_save = ckpt_lib.save

    def late_save(root, step, state, keep=3):
        time.sleep(0.5)                  # the loop runs on meanwhile
        return real_save(root, step, state, keep=keep)

    monkeypatch.setattr(ckpt_lib, "save", late_save)
    snaps = {}
    tc = TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=3, keep=5,
                       log_every=1)
    tr = Trainer(model, opt, tc, seed=1)
    tr.fit(_stream(cfg), steps=6, on_metrics=lambda s, m: snaps.setdefault(
        s, _t_leaves((tr.params, tr.opt_state))))
    tr.close()
    assert 3 in tr.ckpt.saved_steps
    _, state = ckpt_lib.restore(tmp_path, (tr.params, tr.opt_state), step=3)
    for a, b in zip(snaps[3], _t_leaves(state)):
        np.testing.assert_array_equal(a, b)


def test_trainer_straggler_detection(tiny, tmp_path):
    """One stalled feed (1 s) against steps of a few ms.  One intra-op
    thread keeps the steps' own times steady when other test processes
    share the cores (the EMA starts at step 2)."""
    cfg, model, opt = tiny
    tc = TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=1000,
                       straggler_factor=2.0, log_every=1,
                       async_checkpoint=False)
    tr = Trainer(model, opt, tc)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tr.fit(_stream(cfg, slow_at=8), steps=12)
    finally:
        torch.set_num_threads(threads)
    assert tr.straggler_steps >= 1, [h["dt_s"] for h in tr.history]


def test_trainer_telemetry_nbw(tiny, tmp_path):
    cfg, model, opt = tiny
    tc = TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=1000,
                       async_checkpoint=False)
    tr = Trainer(model, opt, tc)
    tr.fit(_stream(cfg), steps=3)
    assert tr.telemetry["step"].read() == 3
    assert np.isfinite(tr.telemetry["loss"].read())


# ---------------------------------------------------------------------------
# launcher
# ---------------------------------------------------------------------------
def test_launcher_trains_and_resumes_on_cpu(tmp_path, capsys):
    args = ["--smoke", "--device", "cpu", "--batch", "2", "--seq", "16",
            "--ckpt-dir", str(tmp_path), "--log-every", "1"]
    tr = launcher.main(args + ["--steps", "3"])
    assert tr.step == 3 and ckpt_lib.latest_step(tmp_path) == 3
    tr = launcher.main(args + ["--steps", "2", "--resume"])
    assert tr.step == 5 and ckpt_lib.latest_step(tmp_path) == 5
    out = capsys.readouterr().out
    assert "step     5  loss" in out and "done: 5 steps" in out


def test_training_entry_points_refuse_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher.main(["--smoke", "--ckpt-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(get_smoke_config("smollm-135m"), remat_policy="none")
