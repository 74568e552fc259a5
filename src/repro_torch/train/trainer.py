"""Training loop: checkpoint/restart, straggler detection, NBW telemetry.

As ``src/repro/train/trainer.py:38-149``.  The trainer composes the
lock-free pieces:

  data:        lock-free MPSC pipeline (repro_torch.data.pipeline)
  step:        the eager train step (repro_torch.train.train_step)
  checkpoint:  NBW-published async writer (repro_torch.train.checkpoint)
  telemetry:   NBW scalar cells (step, loss) any monitor thread can poll

  * restart — ``Trainer(..., resume=True)`` restores the newest intact
    checkpoint (atomic directories and CRC manifests).
  * no checkpoints — ``ckpt_every <= 0`` writes none, not even the final
    one ``close`` writes otherwise (the JAX trainer divides by it).  A
    full-width smoke run of a multi-billion-parameter model would else
    end by writing its whole optimizer state (23 GB for zamba2-2.7b).
  * stragglers — each iteration's wall time (data wait included) feeds an
    EMA; an iteration slower than ``straggler_factor`` x the EMA counts as
    a straggler.  Step 1 is left out: it pays the first-use costs (the
    kernels' build and load on the card).

Elastic re-meshing (``Trainer.remesh``) belongs to the parallelism slice.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from repro_torch.core import nbw
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.optimizer import AdamW
from repro_torch.train.train_step import make_train_step


def _default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclasses.dataclass
class TrainerConfig:
    ckpt_dir: str = dataclasses.field(default_factory=_default_ckpt_dir)
    ckpt_every: int = 50
    keep: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0
    ema_beta: float = 0.9
    async_checkpoint: bool = True


class Trainer:
    """Parameters are drawn by ``model.init`` from ``generator``, or from a
    generator on the model's device seeded with ``seed``; ``resume``
    replaces them (and the optimizer state) by the newest checkpoint."""

    def __init__(self, model, opt: AdamW, cfg: TrainerConfig,
                 generator: Optional[torch.Generator] = None, seed: int = 0,
                 resume: bool = False):
        self.model, self.opt, self.cfg = model, opt, cfg
        self._step = make_train_step(model, opt)
        if generator is None:
            generator = torch.Generator(device=model.device).manual_seed(seed)
        self.params = model.init(generator)
        self.opt_state = opt.init(self.params)
        self.step = 0

        if resume:
            latest = ckpt_lib.latest_step(cfg.ckpt_dir)
            if latest is not None:
                self.step, (self.params, self.opt_state) = ckpt_lib.restore(
                    cfg.ckpt_dir, (self.params, self.opt_state))

        self.ckpt = (ckpt_lib.AsyncCheckpointer(cfg.ckpt_dir, keep=cfg.keep)
                     if cfg.async_checkpoint and cfg.ckpt_every > 0
                     else None)
        # NBW telemetry cells: monitors read without locking the loop.
        self.telemetry = {"step": nbw.HostNBW(), "loss": nbw.HostNBW()}
        self._ema_dt: Optional[float] = None
        self.straggler_steps = 0
        self.history: list = []

    def _to_device(self, batch: Dict[str, np.ndarray]
                   ) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.model.device)
                for k, v in batch.items()}

    # -- loop -----------------------------------------------------------------
    def fit(self, batches: Iterable[Dict[str, np.ndarray]], steps: int,
            on_metrics: Optional[Callable[[int, Dict], None]] = None):
        it = iter(batches)
        target = self.step + steps
        while self.step < target:
            # Time the whole iteration: a stalled data feed is a straggler
            # symptom just like a slow device.
            t0 = time.monotonic()
            batch = self._to_device(next(it))
            self.params, self.opt_state, metrics = self._step(
                self.params, self.opt_state, batch)
            loss = float(metrics["loss"])  # sync point = step boundary
            dt = time.monotonic() - t0
            self.step += 1

            if self.step == 1:
                pass
            elif self._ema_dt is None:
                self._ema_dt = dt
            else:
                if dt > self.cfg.straggler_factor * self._ema_dt:
                    self.straggler_steps += 1
                b = self.cfg.ema_beta
                self._ema_dt = b * self._ema_dt + (1 - b) * dt

            self.telemetry["step"].write(self.step)
            self.telemetry["loss"].write(loss)
            if self.step % self.cfg.log_every == 0 or self.step == target:
                self.history.append(
                    {"step": self.step, "loss": loss, "dt_s": dt,
                     "grad_norm": float(metrics["grad_norm"]),
                     "stragglers": self.straggler_steps})
                if on_metrics:
                    on_metrics(self.step, self.history[-1])
            every = self.cfg.ckpt_every
            if every > 0 and self.step % every == 0:
                self.save()
        return self.history

    # -- checkpointing --------------------------------------------------------
    def save(self) -> None:
        state = (self.params, self.opt_state)
        if self.ckpt is not None:
            self.ckpt.publish(self.step, state)
        else:
            ckpt_lib.save(self.cfg.ckpt_dir, self.step, state,
                          keep=self.cfg.keep)

    def close(self) -> None:
        if self.cfg.ckpt_every > 0:
            self.save()
        if self.ckpt is not None:
            self.ckpt.close()
