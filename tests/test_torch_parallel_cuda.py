"""The port's parallelism on the card (``pytest -m cuda``): the functional
NBB/NBW cells on CUDA tensors with no host sync, ``pipeline_apply`` at
one stage over an NCCL world of one, and a sharded SMOKE train step on
``make_host_mesh()`` equal to the unsharded one.  Imports no JAX;
skipped without a card."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import nbb, nbw  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.parallel import sharding as sh  # noqa: E402
from repro_torch.parallel.pipeline import (pipeline_apply,  # noqa: E402
                                           pipeline_reference)
from repro_torch.train import tree  # noqa: E402
from repro_torch.train.train_step import (batch_shardings,  # noqa: E402
                                          loss_and_grads, param_shardings)


@pytest.fixture(scope="module")
def host_mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (NCCL and the kernels have no CPU "
                    "mode)")
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh()
    yield mesh
    dist.destroy_process_group()


def _sequence(device):
    out = []
    s = nbb.init(2, torch.zeros(3, device=device))
    for i in range(3):
        s, st = nbb.insert_item(s, torch.full((3,), i + 1.0, device=device))
        out += [st, nbb.size(s)]
    for _ in range(3):
        s, item, st = nbb.read_item(s)
        out += [item, st]
    c = nbw.init(3, torch.zeros(3, device=device))
    for i in range(4):
        c = nbw.write(c, torch.full((3,), float(i), device=device))
        out += list(nbw.read(c))
    return out


@pytest.mark.cuda
def test_nbb_nbw_on_card_without_host_sync(host_mesh):
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        dev = _sequence("cuda")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    cpu = _sequence("cpu")
    for a, b in zip(dev, cpu):
        assert torch.equal(a.cpu(), b)
    assert int(dev[4]) == nbb.BUFFER_FULL
    assert int(dev[11]) == nbb.BUFFER_EMPTY


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["barrier", "nbb", "nbb2"])
def test_pipeline_one_stage_on_card(host_mesh, schedule):
    g = torch.Generator(device="cuda").manual_seed(3)
    params = {"w": torch.randn(1, 32, 32, generator=g, device="cuda"),
              "b": torch.randn(1, 32, generator=g, device="cuda")}
    mbs = torch.randn(5, 4, 32, generator=g, device="cuda")

    def stage_fn(p, x):
        return torch.tanh(x @ p["w"] * 0.3 + p["b"] * 0.1)

    got = pipeline_apply(stage_fn, params, mbs, host_mesh, axis="model",
                         schedule=schedule).full_tensor()[-1]
    want = pipeline_reference(stage_fn, params, mbs, 1)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["smollm-135m", "olmoe-1b-7b"])
def test_sharded_smoke_step_on_card(host_mesh, arch):
    """A SMOKE step (f32) under make_host_mesh(): the loss and every
    gradient equal to the unsharded step's (flash on local shards)."""
    from torch.distributed.tensor.experimental import implicit_replication
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int32)).cuda()
    batch = {"tokens": tok}
    loss0, _, g0 = loss_and_grads(model, params, batch)
    with sh.axis_rules(host_mesh, cfg.mesh_rules), implicit_replication():
        dp = tree.map_leaves(sh.distribute, params,
                             param_shardings(model, host_mesh))
        db = tree.map_leaves(sh.distribute, batch,
                             batch_shardings(host_mesh, batch))
        loss1, _, g1 = loss_and_grads(model, dp, db)
    assert abs(float(loss0) - float(sh.full(loss1))) <= 2e-5
    for a, b in zip(tree.flatten(g0)[0], tree.flatten(g1)[0]):
        torch.testing.assert_close(sh.full(b), a, atol=2e-5, rtol=2e-5)
