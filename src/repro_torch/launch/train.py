"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

Composes the stack: config registry -> model (remat policy) -> train step
-> lock-free data pipeline (2 producer threads) -> Trainer (async NBW
checkpoints, restart, straggler detection, telemetry).  Runs on the card
unless ``--device cpu``; weights are random, drawn from seed 0 (the JAX
launcher's ``PRNGKey(0)``).  On the CPU use a smoke-size config
(``--smoke``).  The production meshes
(``--mesh`` of the JAX launcher) belong to the parallelism slice.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.data.pipeline import DataPipeline
from repro_torch.models.model import REMAT_POLICIES, build_model
from repro_torch.train.optimizer import AdamW, OptConfig
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
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg, remat_policy=args.remat, device=args.device)
    opt = AdamW(OptConfig(lr=args.lr, warmup_steps=args.warmup_steps,
                          total_steps=args.steps))
    tc = TrainerConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                       log_every=args.log_every)
    trainer = Trainer(model, opt, tc, resume=args.resume)
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


if __name__ == "__main__":
    main()
