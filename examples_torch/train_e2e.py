"""End-to-end training example: train a smollm model for a few hundred
steps through the full stack — lock-free data pipeline, train step,
async NBW checkpointing, straggler telemetry — and verify the loss
decreases and a restart resumes from the newest checkpoint.

    PYTHONPATH=src python examples_torch/train_e2e.py               # ~25M proxy
    PYTHONPATH=src python examples_torch/train_e2e.py --full-135m   # smollm-135m
    PYTHONPATH=src python examples_torch/train_e2e.py --device cpu  # no card

The default is a width-reduced smollm variant; ``--full-135m`` runs the
real config at full width.  Runs on the card unless ``--device cpu``;
the tok/s line names the device it measured.  A second run with the same
``--ckpt-dir`` resumes from the first run's final checkpoint.
"""
import argparse
import dataclasses
import os
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import DataPipeline  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.train import checkpoint as ckpt_lib  # noqa: E402
from repro_torch.train import tree  # noqa: E402
from repro_torch.train.optimizer import AdamW, OptConfig  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full-135m", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_e2e"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no silent fallback")
    args = ap.parse_args(argv)

    cfg = get_config("smollm-135m")
    if not args.full_135m:
        # same family/topology, ~25M params: a "100M-class" proxy
        cfg = dataclasses.replace(cfg, name="smollm-25m", num_layers=8,
                                  d_model=384, num_heads=6, num_kv_heads=2,
                                  d_ff=1024, vocab_size=16384)
    model = build_model(cfg, device=args.device)
    opt = AdamW(OptConfig(lr=6e-4, warmup_steps=20, total_steps=args.steps))
    tc = TrainerConfig(ckpt_dir=args.ckpt_dir, ckpt_every=50, log_every=10)
    trainer = Trainer(model, opt, tc, resume=True)
    start = trainer.step
    n = sum(p.numel() for p in tree.flatten(trainer.params)[0])
    print(f"{cfg.name}: {n / 1e6:.1f}M params, resume from step {start}")

    pipe = DataPipeline(batch=args.batch, seq_len=args.seq,
                        vocab=cfg.vocab_size, nproducers=2, seed=0)
    t0 = time.monotonic()
    try:
        hist = trainer.fit(
            pipe, steps=args.steps,
            on_metrics=lambda s, m: print(
                f"step {s:4d}  loss {m['loss']:.4f}  "
                f"{m['dt_s'] * 1e3:.0f} ms/step", flush=True))
    finally:
        pipe.close()
        trainer.close()
    dt = time.monotonic() - t0
    tok_s = args.steps * args.batch * args.seq / dt
    where = (torch.cuda.get_device_name(model.device)
             if model.device.type == "cuda" else "CPU")
    print(f"\n{args.steps} steps in {dt:.0f}s ({tok_s:.0f} tok/s {where})")
    print(f"loss: {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}")
    print(f"checkpoints: {ckpt_lib.latest_step(args.ckpt_dir)} (latest)")
    # A run shorter than log_every logs one point: nothing to compare.
    assert len(hist) < 2 or hist[-1]["loss"] < hist[0]["loss"], \
        "loss must decrease"
    return {"history": hist, "resumed_from": start, "params": n,
            "seconds": dt, "tok_s": tok_s}


if __name__ == "__main__":
    main()
