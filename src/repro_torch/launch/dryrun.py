"""Production-mesh dry-run: plan every (arch x shape x mesh) cell on a
fake process group (``src/repro/launch/dryrun.py``).

The JAX dry-run lowers and compiles each cell for 512 placeholder
devices.  The port runs the cell's step once as rank 0 of a fake process
group of 256 (16x16) or 512 (2x16x16) ranks, with fake tensors: DTensor
plans every shard and collective, nothing is computed and no memory is
allocated.  An :class:`~repro_torch.launch.hlo_analysis.Accountant` below
DTensor counts what that one device would run.  One process holds one
default process group, so each cell of ``--all`` runs in a process of its
own.

For each cell the JSON keeps the JAX dry-run's keys where they mean the
same thing:
  * ``flops_per_device``, ``bytes_accessed_per_device``,
    ``collective_bytes_per_device`` / ``collective_counts`` by kind;
  * ``memory``: live local-shard bytes — ``argument_bytes`` (parameters,
    optimizer state and batch, or the serving inputs), ``output_bytes``,
    ``temp_bytes`` (the step's peak live results beyond its outputs) and
    ``peak_estimate_bytes`` (arguments + outputs + temporaries);
    ``argument_bytes_from_specs`` is the same count derived from the
    specs alone;
  * ``fits``: the peak estimate against one card's memory
    (``device_memory_bytes``: the card present, else an H100 80GB HBM3).
These are plan estimates, not measurements on a card.

Train cells run the sharded train step.  Prefill and decode cells run
the serving step batch-parallel (``serving_layout``): each rank serves
its own rows with the whole model, as the port's engine takes no mesh.
The recurrent families' cached prefills, and their train batches of
4097 tokens (no multiple of the chunk), take the sequential scan: the
accountant plans it as the JAX module counts a ``while`` loop, one
step's operations (and their backward) times the trip count
(``hlo_analysis.scan``), so a 32k-token scan costs the plan one step a
layer.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.configs import shapes_for
from repro_torch.launch import hlo_analysis
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.config import SHAPES
from repro_torch.models.inputs import (decode_specs, prefill_specs,
                                       train_batch_specs)
from repro_torch.models.model import build_model
from repro_torch.parallel import sharding as shlib
from repro_torch.train import tree
from repro_torch.train.optimizer import AdamW, OptConfig
from repro_torch.train.train_step import (batch_shardings,
                                          make_train_step,
                                          opt_state_shardings,
                                          param_shardings)

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

# One H100 SXM's memory, used when no card is present to ask.
H100_80GB_HBM3_BYTES = 80 * 10 ** 9


def device_memory_bytes() -> int:
    if torch.cuda.is_available():
        return torch.cuda.get_device_properties(0).total_memory
    return H100_80GB_HBM3_BYTES


def _fake_world(world: int) -> None:
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(f"this process already holds a world of "
                               f"{dist.get_world_size()} ranks; a "
                               f"{world}-rank cell needs its own process")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _local_bytes(t) -> int:
    leaves = tree.flatten(t)[0]
    n = 0
    for x in leaves:
        if isinstance(x, torch.Tensor):
            loc = x.to_local() if shlib.is_dtensor(x) else x
            n += loc.numel() * loc.element_size()
    return n


def _spec_bytes(values, shardings, mesh) -> int:
    """Rank 0's bytes of ``values`` under ``shardings``, from the specs
    and shapes alone."""
    n = 0
    for x, sh in zip(tree.flatten(values)[0], tree.flatten(shardings)[0]):
        shape = shlib.local_shape(tuple(x.shape), sh.spec, mesh)
        k = 1
        for d in shape:
            k *= d
        n += k * x.element_size()
    return n


def _fake_like(specs):
    return tree.map_leaves(
        lambda s: torch.zeros(tuple(s.shape), dtype=s.dtype), specs)


def dryrun_cell(arch: str, shape_name: str, multi_pod: bool = False,
                opt_cfg: OptConfig = None, remat: str = "nothing",
                rules_override=None, microbatches: int = 1,
                verbose: bool = True, smoke: bool = False):
    """Plan one cell; ``smoke`` takes the arch's SMOKE config (a quick
    check of the plumbing).  ``shape_name`` names a ``SHAPES`` cell, or
    is a ``ShapeConfig`` of its own."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    _fake_world(512 if multi_pod else 256)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    shape_name = shape.name
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    model = build_model(cfg, remat_policy=remat, device="cpu")
    if opt_cfg is None:
        # arctic-480b needs 8-bit optimizer state to fit.
        opt_cfg = OptConfig(state_dtype="int8" if arch == "arctic-480b"
                            else "float32")
    opt = AdamW(opt_cfg)
    rules = dict(cfg.mesh_rules or {})
    if rules_override:
        rules.update(rules_override)

    t0 = time.time()
    acc = hlo_analysis.Accountant(track_memory=True, planning=True)
    layout = "sharded"
    with FakeTensorMode(allow_non_fake_inputs=True), \
            shlib.axis_rules(mesh, rules), implicit_replication():
        params_abs = model.init(torch.Generator().manual_seed(0))
        p_sh = param_shardings(model, mesh)
        if shape.kind == "train":
            batch_abs = _fake_like(train_batch_specs(cfg, shape))
            o_sh = opt_state_shardings(model, opt, mesh, params_abs)
            b_sh = batch_shardings(mesh, batch_abs)
            values = (params_abs, opt.init(params_abs), batch_abs)
            shardings = (p_sh, o_sh, b_sh)
            args = tree.map_leaves(shlib.distribute, values, shardings)
            step = make_train_step(model, opt, microbatches=microbatches)
            t_plan = time.time() - t0
            t0 = time.time()
            with acc:
                new_p, new_o, _ = step(*args)
            outputs = (new_p, new_o)
        else:
            layout = "batch-parallel; weights replicated"
            values, shardings, args, step = _serving_cell(
                model, cfg, shape, mesh, params_abs)
            local = tree.map_leaves(lambda x: x.to_local(), args)
            t_plan = time.time() - t0
            t0 = time.time()
            with acc:
                outputs = step(*local)
        t_run = time.time() - t0
        arg_bytes = _local_bytes(args)
        spec_bytes = _spec_bytes(values, shardings, mesh)
        out_bytes = _local_bytes(outputs)

    a = acc.account
    temp = max(acc.peak_bytes - out_bytes, 0)
    mem_cap = device_memory_bytes()
    result = {
        "arch": arch if not smoke else f"{arch}:smoke", "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_devices": mesh.size(),
        "kind": shape.kind,
        "remat": remat,
        "microbatches": microbatches,
        "serving_layout": layout,
        "plan_s": round(t_plan, 1), "run_s": round(t_run, 1),
        "flops_per_device": a.flops,
        "bytes_accessed_per_device": a.bytes,
        "bytes_min_per_device": a.bytes_min,
        "collective_bytes_per_device": dict(a.collective_bytes),
        "collective_counts": dict(a.collective_counts),
        "memory": {
            "argument_bytes": arg_bytes,
            "argument_bytes_from_specs": spec_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": temp,
            "alias_bytes": 0,
            "peak_estimate_bytes": arg_bytes + out_bytes + temp,
        },
        "device_memory_bytes": mem_cap,
        "fits": arg_bytes + out_bytes + temp <= mem_cap,
        "param_count": cfg.param_count(),
        "active_param_count": cfg.active_param_count(),
        "estimate": "plan on a fake process group; not a card measurement",
    }
    if verbose:
        peak_gb = result["memory"]["peak_estimate_bytes"] / 1e9
        print(f"[dryrun] {result['arch']} x {shape_name} x {result['mesh']}: "
              f"{result['flops_per_device'] / 1e12:.3f} TF/dev, "
              f"peak ~{peak_gb:.2f} GB/dev (estimate), "
              f"colls {sum(a.collective_counts.values()):.0f}", flush=True)
    return result


def _serving_cell(model, cfg, shape, mesh, params_abs):
    """(values, shardings, placed arguments, step) of a prefill or decode
    step on this rank's rows (the batch over the batch axes when it
    divides), with the whole model on every rank."""
    from repro_torch.parallel.sharding import NamedSharding, P
    full = tree.map_leaves(lambda x: NamedSharding(mesh, P()), params_abs)
    b = shlib.batch_entry(shape.global_batch, mesh)

    def rows(x):
        """The batch axes on the leaf's batch dimension (the first of the
        global batch's size: caches stack layers before it)."""
        entries = [None] * x.dim()
        dims = [i for i, n in enumerate(x.shape) if n == shape.global_batch]
        if dims:
            entries[dims[0]] = b
        return NamedSharding(mesh, P(*entries))

    if shape.kind == "prefill":
        specs = _fake_like(prefill_specs(cfg, shape))
        values = (params_abs, specs)
        shardings = (full, tree.map_leaves(rows, specs))

        def step(params, inp):
            return model.prefill(params, inp["tokens"], shape.seq_len,
                                 extras=inp.get("extras"))
    else:
        specs = decode_specs(cfg, shape, model)
        specs = _fake_like(specs)
        values = (params_abs, specs)
        shardings = (full, tree.map_leaves(rows, specs))

        def step(params, inp):
            return model.decode_step(params, inp["caches"], inp["tokens"],
                                     inp["pos"])
    return (values, shardings,
            tree.map_leaves(shlib.distribute, values, shardings), step)


def save(result, tag=""):
    RESULTS.mkdir(parents=True, exist_ok=True)
    name = f"{result['arch']}__{result['shape']}__{result['mesh']}{tag}.json"
    path = RESULTS / name.replace(":", "_")
    path.write_text(json.dumps(result, indent=1))
    return path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list_archs())
    ap.add_argument("--shape", default="train_4k", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="every arch x shapes_for(arch) x both meshes, "
                         "each cell in a process of its own")
    ap.add_argument("--remat", default="nothing")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    if args.all:
        failures = []
        for arch in list_archs():
            for shape in shapes_for(arch):
                for mp in (False, True):
                    tag = "2x16x16" if mp else "16x16"
                    out = RESULTS / f"{arch}__{shape.name}__{tag}.json"
                    if args.skip_existing and out.exists():
                        continue
                    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                           "--arch", arch, "--shape", shape.name,
                           "--remat", args.remat] + (
                               ["--multi-pod"] if mp else [])
                    rc = subprocess.run(cmd, env=dict(os.environ)).returncode
                    if rc:
                        failures.append((arch, shape.name, tag))
                        print(f"[dryrun] FAIL {arch} x {shape.name} x {tag}",
                              flush=True)
        print(f"\n[dryrun] done; {len(failures)} failures")
        for f in failures:
            print("  FAIL:", *f)
        sys.exit(1 if failures else 0)
    if args.arch is None:
        ap.error("--arch is required without --all")
    result = dryrun_cell(args.arch, args.shape, args.multi_pod,
                         remat=args.remat)
    save(result)
    print(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
