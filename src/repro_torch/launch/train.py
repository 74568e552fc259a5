"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

Composes the stack: config registry -> model (remat policy) -> train step
-> lock-free data pipeline (2 producer threads) -> Trainer (async NBW
checkpoints, restart, straggler detection, telemetry).  Runs on the card
unless ``--device cpu``; weights are random, drawn from seed 0 (the JAX
launcher's ``PRNGKey(0)``).  On the CPU use a smoke-size config
(``--smoke``).

``--mesh single|multi`` trains on the production mesh (16x16 or 2x16x16,
``launch.mesh``): parameters, optimizer state (ZeRO over ``data``) and
batches are DTensors placed by the model's logical-axis rules.  The
process group comes from the launcher's environment (``torchrun``: one
process per rank, 256 or 512 of them); with fewer ranks the mesh is
refused with a message.  Every rank runs its own data pipeline; the
Trainer steps on rank 0's batches and rank 0 alone writes checkpoints,
so ``--ckpt-dir`` must be a directory every rank reads for ``--resume``.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.data.pipeline import DataPipeline
from repro_torch.models.model import REMAT_POLICIES, build_model
from repro_torch.parallel import sharding as shlib
from repro_torch.train.optimizer import AdamW, OptConfig
from repro_torch.train.train_step import (abstract_params, batch_shardings,
                                          opt_state_shardings,
                                          param_shardings)
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None) -> Trainer:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m", choices=list_archs())
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no silent fallback")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup-steps", type=int,
                    default=OptConfig.warmup_steps)
    ap.add_argument("--remat", default="nothing", choices=REMAT_POLICIES)
    ap.add_argument("--ckpt-dir", default=TrainerConfig().ckpt_dir)
    ap.add_argument("--ckpt-every", type=int, default=50,
                    help="steps between checkpoints; 0 writes none, not "
                         "even the final one")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--mesh", default="none",
                    choices=["none", "single", "multi"],
                    help="production mesh (requires >= 256 devices)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg, remat_policy=args.remat, device=args.device)
    opt = AdamW(OptConfig(lr=args.lr, warmup_steps=args.warmup_steps,
                          total_steps=args.steps))
    tc = TrainerConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                       log_every=args.log_every)
    mesh = shardings = None
    if args.mesh != "none":
        try:
            mesh = _production_mesh(args.mesh == "multi", model.device.type)
        except RuntimeError as e:
            ap.error(str(e))
        shardings = _shardings(model, opt, mesh, args)
    trainer = Trainer(model, opt, tc, resume=args.resume, mesh=mesh,
                      shardings=shardings)
    pipe = DataPipeline(batch=args.batch, seq_len=args.seq,
                        vocab=cfg.vocab_size, nproducers=2)
    try:
        hist = trainer.fit(
            pipe, steps=args.steps,
            on_metrics=lambda s, m: print(
                f"step {s:5d}  loss {m['loss']:.4f}  "
                f"gnorm {m['grad_norm']:.2f}  {m['dt_s'] * 1e3:.0f} ms",
                flush=True))
    finally:
        pipe.close()
        trainer.close()
    print(f"done: {trainer.step} steps, final loss "
          f"{hist[-1]['loss']:.4f}, stragglers {trainer.straggler_steps}")
    return trainer


def _production_mesh(multi_pod: bool, device_type: str):
    """The production mesh over the world the launcher's environment
    describes (``torchrun`` sets ``WORLD_SIZE``/``RANK``)."""
    import os

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_production_mesh
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo")
    return make_production_mesh(multi_pod=multi_pod, device_type=device_type)


def _shardings(model, opt, mesh, args):
    """(params, optimizer state, batch) shardings on ``mesh``, from
    shapes alone (fake tensors)."""
    import torch
    with shlib.axis_rules(mesh, model.cfg.mesh_rules):
        p_sh = param_shardings(model, mesh)
        o_sh = opt_state_shardings(model, opt, mesh, abstract_params(model))
        b_sh = batch_shardings(mesh, {"tokens": torch.empty(
            (args.batch, args.seq), device="meta")})
    return p_sh, o_sh, b_sh


if __name__ == "__main__":
    main()
