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
  * sharded state — ``Trainer(mesh=, shardings=(params, opt state,
    batch))`` distributes the parameters and the optimizer state as
    DTensors and each batch on arrival, and runs the step under the
    model's logical-axis rules on that mesh (``trainer.py:52-94`` there).
  * elastic scaling — ``remesh(mesh, shardings)`` gathers the state to
    full tensors and distributes it again (``remesh(None, None)``: plain
    tensors, no mesh).  The state stays mesh-agnostic: checkpoints hold
    full tensors.
  * several ranks — in a process group of more than one rank the Trainer
    is collective: every rank builds it, fits it and closes it, and a
    mesh spans the whole group.  Each batch is broadcast from rank 0
    before it is distributed (``DataPipeline`` does not promise one
    order, so the ranks' own feeds may differ), and rank 0 alone writes
    checkpoints; ``close`` waits at a barrier until the last one is on
    disk.  A resume reads the directory on every rank, so it must be
    one that every rank sees.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import nbw
from repro_torch.parallel import sharding as shlib
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import tree
from repro_torch.train.optimizer import AdamW
from repro_torch.train.train_step import make_train_step


def _world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


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
                 resume: bool = False, mesh=None,
                 shardings: Optional[tuple] = None):
        self.model, self.opt, self.cfg = model, opt, cfg
        self._step = make_train_step(model, opt)
        self.mesh, self.shardings = None, None
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

        self.remesh(mesh, shardings)
        # Several ranks hold the same full state: one of them writes it.
        self._writer = _world_size() == 1 or dist.get_rank() == 0
        self.ckpt = (ckpt_lib.AsyncCheckpointer(cfg.ckpt_dir, keep=cfg.keep)
                     if cfg.async_checkpoint and cfg.ckpt_every > 0
                     and self._writer else None)
        # NBW telemetry cells: monitors read without locking the loop.
        self.telemetry = {"step": nbw.HostNBW(), "loss": nbw.HostNBW()}
        self._ema_dt: Optional[float] = None
        self.straggler_steps = 0
        self.history: list = []

    def _to_device(self, batch: Dict[str, np.ndarray]
                   ) -> Dict[str, torch.Tensor]:
        out = {k: torch.as_tensor(v).to(self.model.device)
               for k, v in batch.items()}
        if self.mesh is not None and self.mesh.size() > 1:
            for v in out.values():      # rank 0's batch is the step's
                dist.broadcast(v, src=0)
        if self.shardings is not None:
            out = {k: shlib.distribute(v, self.shardings[2][k])
                   for k, v in out.items()}
        return out

    def remesh(self, mesh, shardings: Optional[tuple] = None) -> None:
        """Elastic scale: gather the state to full tensors, then
        distribute it over ``mesh`` by ``shardings`` = (params, opt state,
        batch) NamedSharding trees; ``shardings=None`` keeps it plain."""
        if mesh is not None and mesh.size() not in (1, _world_size()):
            raise ValueError(f"a Trainer's mesh spans the whole process "
                             f"group: {mesh.size()} of {_world_size()} "
                             f"ranks")
        full = lambda t: tree.map_leaves(shlib.full, t)   # noqa: E731
        self.params, self.opt_state = full(self.params), full(self.opt_state)
        self.mesh, self.shardings = mesh, shardings
        if shardings is not None:
            p_sh, o_sh, _ = shardings
            self.params = tree.map_leaves(shlib.distribute, self.params,
                                          p_sh)
            self.opt_state = tree.map_leaves(shlib.distribute,
                                             self.opt_state, o_sh)

    def _context(self):
        """The step's rules context: the model's logical-axis rules on the
        mesh, plain tensors taken as replicated (positions, masks)."""
        if self.mesh is None:
            return contextlib.nullcontext()
        from torch.distributed.tensor.experimental import \
            implicit_replication
        stack = contextlib.ExitStack()
        stack.enter_context(shlib.axis_rules(self.mesh,
                                             self.model.cfg.mesh_rules))
        stack.enter_context(implicit_replication())
        return stack

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
            with self._context():
                self.params, self.opt_state, metrics = self._step(
                    self.params, self.opt_state, batch)
            loss = float(shlib.full(metrics["loss"]))  # sync: step boundary
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
                     "grad_norm": float(shlib.full(metrics["grad_norm"])),
                     "stragglers": self.straggler_steps})
                if on_metrics:
                    on_metrics(self.step, self.history[-1])
            every = self.cfg.ckpt_every
            if every > 0 and self.step % every == 0:
                self.save()
        return self.history

    # -- checkpointing --------------------------------------------------------
    def save(self) -> None:
        state = tree.map_leaves(shlib.full, (self.params, self.opt_state))
        if not self._writer:
            return
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
        if self.cfg.ckpt_every > 0 and _world_size() > 1:
            dist.barrier()
