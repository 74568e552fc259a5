"""Checks of the port's parallelism that need a process group, run on
every rank of a gloo world (one process per rank) by
``tests/test_torch_parallel.py``.

  python _torch_gloo_worker.py CHECK RANK WORLD PORT DIR

Each rank joins ``tcp://localhost:PORT``, runs CHECK and writes its
results to ``DIR/CHECK_RANK.npz``; the test compares them.  Inputs that
must match the JAX package's run are read from ``DIR/inputs.npz``.
"""
import dataclasses
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_smoke_config
from repro_torch.launch import hlo_analysis
from repro_torch.models import moe as tmoe
from repro_torch.models.model import build_model
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.compression import compressed_psum
from repro_torch.parallel.pipeline import pipeline_apply, pipeline_reference
from repro_torch.train import tree
from repro_torch.train.optimizer import AdamW, OptConfig
from repro_torch.train.train_step import (abstract_params, batch_shardings,
                                          loss_and_grads,
                                          opt_state_shardings,
                                          param_shardings)
from repro_torch.train.trainer import Trainer, TrainerConfig


def _smoke(arch):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    model = build_model(cfg, device="cpu")
    return cfg, model, model.init(torch.Generator().manual_seed(0))


def _max_diff(a, b) -> float:
    la, lb = tree.flatten(a)[0], tree.flatten(b)[0]
    return max(float((x - sh.full(y)).abs().max()) for x, y in zip(la, lb))


def _sharded_loss(model, params, batch, mesh, rules):
    """loss_and_grads with params and batch distributed by the model's
    rules on ``mesh``: (loss, grads as full tensors)."""
    from torch.distributed.tensor.experimental import implicit_replication
    with sh.axis_rules(mesh, rules), implicit_replication():
        p_sh = param_shardings(model, mesh)
        b_sh = batch_shardings(mesh, batch)
        dp = tree.map_leaves(sh.distribute, params, p_sh)
        db = tree.map_leaves(sh.distribute, batch, b_sh)
        loss, _, grads = loss_and_grads(model, dp, db)
    return float(sh.full(loss)), tree.map_leaves(sh.full, grads)


def check_step1(rank, world, d):
    """A world of one: the SMOKE train step's loss and gradients under
    make_host_mesh() against the unsharded step (dense and MoE)."""
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh("cpu")
    out = {}
    for arch in ("smollm-135m", "olmoe-1b-7b"):
        cfg, model, params = _smoke(arch)
        tok = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (2, 16)).astype(np.int32))
        loss0, _, g0 = loss_and_grads(model, params, {"tokens": tok})
        loss1, g1 = _sharded_loss(model, params, {"tokens": tok}, mesh,
                                  cfg.mesh_rules)
        out[f"{arch}_loss"] = np.array([float(loss0), loss1])
        out[f"{arch}_grad_diff"] = np.array(_max_diff(g0, g1))
    return out


def check_ep2(rank, world, d):
    """A world of two, model = 2: the MoE expert-parallel route (4 of 8
    SMOKE experts per rank) against the local route, block and model;
    then Trainers remeshed between the (1, 2) mesh and none (MoE; its
    expert capacity counts local tokens, so a data split changes which
    choices drop, in both packages), and between (2, 1), (1, 2) and none
    (dense), each against a Trainer that never had a mesh."""
    from torch.distributed.device_mesh import init_device_mesh
    mesh12 = init_device_mesh("cpu", (1, 2), mesh_dim_names=("data",
                                                             "model"))
    mesh21 = init_device_mesh("cpu", (2, 1), mesh_dim_names=("data",
                                                             "model"))
    cfg, model, params = _smoke("olmoe-1b-7b")
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((2, 12, cfg.d_model))
                         .astype(np.float32))
    lp = {k: v[0] for k, v in params["layers"]["moe"].items()}
    want, want_aux = tmoe._moe_local(cfg, x, lp)
    with sh.axis_rules(mesh12, cfg.mesh_rules):
        got, got_aux = tmoe.moe_block(lp, cfg, x)
    out = {"block_diff": np.array(float((got - want).abs().max())),
           "aux": np.array([float(want_aux), float(got_aux)])}
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16))
                           .astype(np.int32))
    loss0, _, g0 = loss_and_grads(model, params, {"tokens": tok})
    loss1, g1 = _sharded_loss(model, params, {"tokens": tok}, mesh12,
                              cfg.mesh_rules)
    out["model_loss"] = np.array([float(loss0), loss1])
    out["model_grad_diff"] = np.array(_max_diff(g0, g1))

    out["trainer_losses"] = _remesh_losses(
        model, params, cfg, rng, [mesh12, None, mesh12])
    cfg, model, params = _smoke("smollm-135m")
    out["dense_trainer_losses"] = _remesh_losses(
        model, params, cfg, rng, [mesh21, mesh12, None])
    out.update(_fed_trainer(rank, d, mesh12, cfg, model))
    for name, mesh in (("12", mesh12), ("21", mesh21)):
        for k, v in _adamw_on_shards(mesh, cfg, model, params, rng).items():
            out[f"adamw{name}_{k}"] = v
    return out


def _fed_trainer(rank, d, mesh, cfg, model):
    """A Trainer on ``mesh`` fed by a DataPipeline whose seed differs on
    each rank (its fan-in order is not promised, so the ranks' feeds may
    differ), checkpointing every 2 of 4 steps into one directory: its
    losses, the steps each rank's writer saved, and a Trainer resumed on
    the mesh from that directory against the state it trained.  Rank 0
    also trains the batches it was fed with no mesh."""
    from repro_torch.data.pipeline import DataPipeline
    opt = AdamW(OptConfig(lr=1e-3, warmup_steps=1))
    with sh.axis_rules(mesh, cfg.mesh_rules):
        shardings = (param_shardings(model, mesh),
                     opt_state_shardings(model, opt, mesh,
                                         abstract_params(model)),
                     batch_shardings(mesh, {"tokens": torch.empty(
                         (2, 16), dtype=torch.int32)}))
    tc = TrainerConfig(ckpt_dir=f"{d}/ckpt", ckpt_every=2, log_every=1)
    pipe = DataPipeline(batch=2, seq_len=16, vocab=cfg.vocab_size,
                        nproducers=2, seed=rank)
    fed = []

    def feed():
        for b in pipe:
            fed.append(b)
            yield b

    t = Trainer(model, opt, tc, seed=0, mesh=mesh, shardings=shardings)
    try:
        t.fit(feed(), steps=4)
    finally:
        pipe.close()
        t.close()
    back = Trainer(model, opt, TrainerConfig(ckpt_dir=tc.ckpt_dir,
                                             ckpt_every=0),
                   seed=1, resume=True, mesh=mesh, shardings=shardings)
    out = {"fed_losses": np.array([h["loss"] for h in t.history]),
           "fed_saved": np.array(t.ckpt.saved_steps if t.ckpt else [],
                                 dtype=np.int64),
           "resumed_step": np.array(back.step),
           "resumed_diff": np.array(_max_diff(
               tree.map_leaves(sh.full, (t.params, t.opt_state)),
               (back.params, back.opt_state)))}
    if rank == 0:
        plain = Trainer(model, opt, TrainerConfig(ckpt_every=0,
                                                  log_every=1), seed=0)
        plain.fit(iter(fed), steps=4)
        out["fed_plain_losses"] = np.array([h["loss"]
                                            for h in plain.history])
    return out


def _adamw_on_shards(mesh, cfg, model, params, rng):
    """One AdamW update of DTensor leaves, whole and in row blocks of at
    most 7 elements (``_CHUNK_ELEMS``), against the plain update: the
    largest differences, and the largest ``sqrt`` result (one of the
    update's float32 temporaries) of the blocked run beside a block's
    bytes."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.train import optimizer as topt
    opt = AdamW(OptConfig(lr=1e-2, warmup_steps=1))
    grads = tree.map_leaves(lambda p: torch.from_numpy(
        rng.standard_normal(tuple(p.shape)).astype(np.float32)) * 1e-3,
        params)
    state = opt.init(params)
    want = opt.update(grads, state, params)[:2]
    with sh.axis_rules(mesh, cfg.mesh_rules), implicit_replication():
        p_sh = param_shardings(model, mesh)
        o_sh = opt_state_shardings(model, opt, mesh, params)
        dp, dg = (tree.map_leaves(sh.distribute, x, p_sh)
                  for x in (params, grads))
        do = tree.map_leaves(sh.distribute, state, o_sh)
        whole = opt.update(dg, do, dp)[:2]
        chunk, topt._CHUNK_ELEMS = topt._CHUNK_ELEMS, 7
        try:
            with hlo_analysis.Accountant(record=True) as acc:
                blocked = opt.update(dg, do, dp)[:2]
        finally:
            topt._CHUNK_ELEMS = chunk
    widest = max(p.shape[-1] for p in tree.flatten(params)[0]
                 if p.dim() >= 2)
    return {"blocked_vs_whole": np.array(_max_diff(
                tree.map_leaves(sh.full, whole), blocked)),
            "blocked_vs_plain": np.array(_max_diff(want, blocked)),
            "sqrt_bytes": np.array(max(o.result_bytes for o in acc.ops
                                       if o.kind.startswith("aten.sqrt"))),
            "block_bytes": np.array(4 * widest * max(1, 7 // widest))}


def _remesh_losses(model, params, cfg, rng, meshes):
    """2 steps on each mesh in turn (None: plain tensors), one Trainer
    remeshed between them, beside a Trainer that never had a mesh."""
    opt = AdamW(OptConfig(lr=1e-3, warmup_steps=1))
    tc = TrainerConfig(ckpt_every=0, log_every=1)
    batches = [{"tokens": rng.integers(0, cfg.vocab_size, (2, 16))
                .astype(np.int32)} for _ in range(2 * len(meshes))]
    plain = Trainer(model, opt, tc, seed=0)
    plain.fit(iter(batches), steps=len(batches))

    def shardings(mesh):
        if mesh is None:
            return None
        with sh.axis_rules(mesh, cfg.mesh_rules):
            return (param_shardings(model, mesh),
                    opt_state_shardings(model, opt, mesh, plain.params),
                    batch_shardings(mesh, batches[0]))

    t = Trainer(model, opt, tc, seed=0)
    it = iter(batches)
    for mesh in meshes:
        t.remesh(mesh, shardings(mesh))
        t.fit(it, steps=2)
    return np.array([[h["loss"] for h in plain.history],
                     [h["loss"] for h in t.history]])


def _stage_fn(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def check_ring8(rank, world, d):
    """A world of eight: the three pipeline schedules over 8 stages
    against pipeline_reference (and, in the test, the JAX package's
    values); each schedule's collective bytes at a middle stage; and
    compressed_psum over the 8 ranks, one step and two."""
    from torch.distributed.device_mesh import init_device_mesh
    inp = np.load(f"{d}/inputs.npz")
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("stage",))
    params = {"w": torch.from_numpy(inp["w"]),
              "b": torch.from_numpy(inp["b"])}
    mbs = torch.from_numpy(inp["mbs"])
    out = {"want": pipeline_reference(_stage_fn, params, mbs, world).numpy()}
    for schedule in ("barrier", "nbb", "nbb2"):
        res = pipeline_apply(_stage_fn, params, mbs, mesh, axis="stage",
                             schedule=schedule)
        out[schedule] = res.full_tensor()[-1].numpy()
        # collective bytes of the schedule itself (8 microbatches, d=128)
        p2 = {"w": torch.zeros(world, 128, 128),
              "b": torch.zeros(world, 128)}
        acc = hlo_analysis.analyze(pipeline_apply, _stage_fn, p2,
                                   torch.zeros(8, 4, 128), mesh, "stage",
                                   schedule)
        out[f"{schedule}_bytes"] = np.array(
            sum(acc.collective_bytes.values()))
    group = mesh.get_group("stage")
    g = torch.from_numpy(inp["g"][rank])
    err = torch.zeros_like(g)
    mean1, err1 = compressed_psum({"w": g}, {"w": err}, group, n_shards=8)
    mean2, _ = compressed_psum({"w": g}, err1, group, n_shards=8)
    out["mean1"] = mean1["w"].numpy()
    out["mean2"] = mean2["w"].numpy()
    out["err1"] = err1["w"].numpy()
    return out


CHECKS = {"step1": check_step1, "ep2": check_ep2, "ring8": check_ring8}


def main():
    check, rank, world, port, d = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)        # eight ranks share the host's cores
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        out = CHECKS[check](rank, world, d)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    np.savez(f"{d}/{check}_{rank}.npz", **out)


if __name__ == "__main__":
    main()
