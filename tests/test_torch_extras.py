"""The training-side plumbing of an image or frame source, in the port
against the JAX package at the SMOKE size, float32, for the two
cross-attention families (``llama-3.2-vision-11b``: vlm_cross;
``whisper-tiny``: enc_dec):

- a ``DataPipeline(extras_shape=...)`` batch carries its source under
  ``"extras"``, which ``Model.loss`` does not read in either package
  (``src/repro/models/model.py:568`` reads ``image_embeds`` and
  ``frame_embeds``): the port's loss equals the reference's, and both
  equal the loss with the source dropped;
- ``make_prefill(model, max_len)(params, tokens, extras)`` passes the
  source on to ``Model.prefill``: prefill + 3 decode steps against the
  reference's ``make_prefill``, tokens exact, cache leaves within 2e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import smoke_pair  # noqa: E402
from repro.data.pipeline import DataPipeline as JPipeline  # noqa: E402
from repro.train.train_step import make_prefill as jmake_prefill  # noqa: E402
from repro_torch.data.pipeline import DataPipeline  # noqa: E402
from repro_torch.train import tree  # noqa: E402
from repro_torch.train.train_step import make_prefill  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

TOL = dict(atol=2e-5, rtol=2e-5)
VLM, WHISPER = "llama-3.2-vision-11b", "whisper-tiny"
ARCHS = (VLM, WHISPER)


@pytest.fixture(scope="module")
def pairs():
    return {arch: smoke_pair(arch) for arch in ARCHS}


def _src_key(cfg) -> str:
    return "frame_embeds" if cfg.encoder is not None else "image_embeds"


def _src_shape(cfg) -> tuple:
    n = (cfg.encoder.num_frames if cfg.encoder is not None
         else cfg.num_image_tokens)
    return (n, cfg.d_model)


def _first(pipe):
    try:
        return pipe.get()
    finally:
        pipe.close()


@pytest.mark.parametrize("arch", ARCHS)
def test_pipeline_extras_never_reach_the_loss(pairs, arch):
    cfg, jm, jp, tm, tp = pairs[arch]
    kw = dict(batch=2, seq_len=16, vocab=cfg.vocab_size, nproducers=1,
              seed=0, extras_shape=_src_shape(cfg))
    batch = _first(DataPipeline(**kw))
    jbatch = _first(JPipeline(**kw))
    assert batch.keys() == jbatch.keys() == {"tokens", "extras"}
    for k in batch:
        np.testing.assert_array_equal(batch[k], jbatch[k])

    def port_loss(b):
        with torch.no_grad():
            return float(tm.loss(tp, {k: torch.from_numpy(v)
                                      for k, v in b.items()})[0])

    def ref_loss(b):
        return float(jm.loss(jp, {k: jnp.asarray(v)
                                  for k, v in b.items()})[0])

    tokens_only = {"tokens": batch["tokens"]}
    loss = port_loss(batch)
    np.testing.assert_allclose(loss, ref_loss(jbatch), **TOL)
    assert loss == port_loss(tokens_only)
    assert ref_loss(jbatch) == ref_loss(tokens_only)
    # Under the key the loss reads, the same source changes the loss.
    src = {**tokens_only, _src_key(cfg): batch["extras"]}
    assert abs(port_loss(src) - loss) > 1e-3
    np.testing.assert_allclose(port_loss(src), ref_loss(src), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_make_prefill_passes_extras(pairs, arch):
    cfg, jm, jp, tm, tp = pairs[arch]
    B, T = 2, 11
    tok = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, T))
    src = np.random.default_rng(4).standard_normal(
        (B,) + _src_shape(cfg)).astype(np.float32)
    jt, jc = jmake_prefill(jm, 40)(jp, jnp.asarray(tok, jnp.int32),
                                   extras=jnp.asarray(src))
    with torch.no_grad():
        tt, tc = make_prefill(tm, 40)(tp, torch.from_numpy(tok),
                                      extras=torch.from_numpy(src))
    got, want = [tt.tolist()], [np.asarray(jt).tolist()]
    for i in range(3):
        pos = np.full((B,), T + i, np.int32)
        jt, jc = jm.decode_step(jp, jc, jt[:, None], jnp.asarray(pos))
        with torch.no_grad():
            tt, tc = tm.decode_step(tp, tc, tt[:, None],
                                    torch.from_numpy(pos))
        got.append(tt.tolist())
        want.append(np.asarray(jt).tolist())
    assert got == want
    leaves = tree.flatten(tc)[0]
    for a, b in zip(leaves, jax.tree.leaves(jc)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    # The cross caches hold the source's K/V, not init_cache's zeros.
    cross = [x for x in leaves if x.shape[-3] == src.shape[1]]
    assert len(cross) == 2 and all(bool(x.any()) for x in cross)
