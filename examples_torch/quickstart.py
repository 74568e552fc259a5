"""Quickstart: build a model, take a train step, generate tokens.

    PYTHONPATH=src python examples_torch/quickstart.py [--arch smollm-135m]
    PYTHONPATH=src python examples_torch/quickstart.py --device cpu

Uses the smoke-size config.  On the card (the default device) the train
step runs the flash attention forward and backward kernels and the
prefill runs the flash forward; ``--device cpu`` runs their plain
PyTorch versions.  Without a card the default device refuses to start.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_smoke_config, list_archs  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.train import tree  # noqa: E402
from repro_torch.train.optimizer import AdamW, OptConfig  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m", choices=list_archs())
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no silent fallback")
    args = ap.parse_args(argv)

    # 1. build a model from the registry
    cfg = get_smoke_config(args.arch)
    model = build_model(cfg, device=args.device)
    dev = model.device
    params = model.init(torch.Generator(dev).manual_seed(0))
    n = sum(p.numel() for p in tree.flatten(params)[0])
    print(f"{cfg.name}: {n / 1e6:.2f}M params ({cfg.family})")

    # 2. one train step
    opt = AdamW(OptConfig(lr=1e-3))
    opt_state = opt.init(params)
    step = make_train_step(model, opt)
    tokens = torch.randint(0, cfg.vocab_size, (2, 32), dtype=torch.int32,
                           device=dev,
                           generator=torch.Generator(dev).manual_seed(1))
    batch = {"tokens": tokens}
    if cfg.family == "vlm":
        batch["image_embeds"] = torch.zeros(
            (2, cfg.num_image_tokens, cfg.d_model), dtype=cfg.compute_dtype,
            device=dev)
    if cfg.encoder is not None:
        batch["frame_embeds"] = torch.zeros(
            (2, cfg.encoder.num_frames, cfg.d_model),
            dtype=cfg.compute_dtype, device=dev)
    params, opt_state, metrics = step(params, opt_state, batch)
    loss, grad_norm = float(metrics["loss"]), float(metrics["grad_norm"])
    print(f"train step: loss={loss:.4f} grad_norm={grad_norm:.2f}")

    # 3. prefill + greedy decode
    extras = batch.get("image_embeds", batch.get("frame_embeds"))
    with torch.no_grad():
        tok, caches = model.prefill(params, tokens[:, :8], max_len=32,
                                    extras=extras)
        out = [int(tok[0])]
        for i in range(8, 14):
            tok, caches = model.decode_step(params, caches, tok[:, None], i)
            out.append(int(tok[0]))
    print(f"generated token ids: {out}")
    return {"params": n, "loss": loss, "grad_norm": grad_norm,
            "tokens": out}


if __name__ == "__main__":
    main()
