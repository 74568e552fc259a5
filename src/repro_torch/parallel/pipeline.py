"""NBB ring pipeline: pipeline parallelism as a lock-free circular buffer
(``src/repro/parallel/pipeline.py``).

The paper's NBB (Kim'07) is a FIFO ring where a producer and a consumer
synchronize through two counters and never touch the same slot.  Mapped
onto a mesh axis, the *stages* of a pipeline-parallel model are the
tasks, point-to-point sends along ``DeviceChannel(axis)`` are the MCAPI
channels, and the microbatch slots rotating around the ring are the NBB
buffer:

  * producer counter  = microbatches injected at stage 0 (tick index t),
  * consumer counter  = microbatches retired at stage S-1 (t - (S-1)),
  * slot disjointness = each stage holds exactly one in-flight microbatch
    per tick, by construction — no global barrier, no lock.

Three schedules, the paper's lock-based vs lock-free test matrix:

  "barrier"  — the *lock-based analogue*: every tick all-gathers every
               stage's activation over the stage group and each stage
               selects its input: one shared partition every writer and
               reader serializes through.  Collective bytes per tick
               scale with the number of stages.
  "nbb"      — the lock-free ring: one point-to-point send and receive per
               tick.  Collective bytes per tick are one activation,
               independent of the stage count.
  "nbb2"     — the 2-slot ring (ring depth 2): the exchange of the slot
               filled at tick t-1 is posted before the compute of tick t
               and waited after it, so the transfer overlaps the compute —
               NBB's producer running ahead of its consumer.

All schedules compute the same values; they differ only in their
collective schedule, which is the paper's point.  Each runs tick for tick
as the JAX module's ``lax.scan`` does; the stage's own branches are
Python branches on its rank.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.core.channels import DeviceChannel
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import P
from repro_torch.train import tree


def _exchange(y: torch.Tensor, recv: torch.Tensor, group, axis: str,
              stage: int, n_stages: int):
    """Post this stage's send of ``y`` to its ring successor and its
    receive into ``recv`` from its predecessor (``DeviceChannel.perm``);
    returns the requests to wait on.  One stage is its own neighbour: a
    local copy."""
    import torch.distributed as dist
    pairs = DeviceChannel(axis).perm(n_stages)
    dst = pairs[stage][1]
    src = next(s for s, d in pairs if d == stage)
    if dst == stage and src == stage:
        recv.copy_(y)
        return []
    glob = lambda r: dist.get_global_rank(group, r)   # noqa: E731
    return dist.batch_isend_irecv([
        dist.P2POp(dist.isend, y.contiguous(), glob(dst), group),
        dist.P2POp(dist.irecv, recv, glob(src), group)])


def _wait(reqs) -> None:
    for r in reqs:
        r.wait()


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any,
                   microbatches: torch.Tensor,
                   mesh,
                   axis: str = "model",
                   schedule: str = "nbb") -> torch.Tensor:
    """Run ``microbatches`` through ``n_stages`` pipeline stages, one per
    rank of ``mesh``'s ``axis``.

    stage_fn(params_for_stage, x[mb, ...]) -> y[mb, ...] (same shape).
    stage_params: tree with leading dim == the axis size (one slice per
      stage): DTensors split on dim 0, or full tensors every rank holds.
    microbatches: [n_micro, mb, ...], the same on every rank.
    Returns a DTensor [n_stages, n_micro, mb, ...] split over ``axis`` on
    dim 0; ``result.full_tensor()[-1]`` is the final stage's output.
    Each stage returns its own slab, so delivery adds no collective: the
    schedule's own exchanges are all the traffic there is.
    """
    if schedule not in ("barrier", "nbb", "nbb2"):
        raise ValueError(f"unknown schedule {schedule!r}")
    import torch.distributed._functional_collectives as funcol
    n_stages = sharding.mesh_axis_size(mesh, axis)
    n_micro = microbatches.shape[0]
    group = mesh.get_group(axis)
    sid = mesh.get_local_rank(axis)
    first, last = sid == 0, sid == n_stages - 1
    params = tree.map_leaves(
        lambda a: sharding.to_local(a, mesh, _on_dim0(a.dim(), axis))[0],
        stage_params)
    mbs = sharding.full(microbatches)
    zero = torch.zeros(mbs.shape[1:], dtype=mbs.dtype, device=mbs.device)

    def inject(t):
        return mbs[t] if t < n_micro else zero

    outs = []
    if schedule in ("barrier", "nbb"):
        n_ticks = n_micro + n_stages - 1
        buf = zero
        for t in range(n_ticks):
            x = inject(t) if first else buf
            y = stage_fn(params, x)
            if schedule == "nbb":
                nxt = torch.empty_like(y)
                _wait(_exchange(y, nxt, group, axis, sid, n_stages))
            else:
                # lock-based analogue: global exchange, local select
                all_y = funcol.wait_tensor(funcol.all_gather_tensor(
                    y.contiguous(), 0, group)).view((n_stages,) + y.shape)
                nxt = zero if first else all_y[sid - 1]
            buf = nxt
            outs.append(y if last else zero)
        outs = torch.stack(outs)[n_stages - 1:n_stages - 1 + n_micro]
    else:
        # Stage s sees microbatch m at tick 2*s + m; 2*(S-1) + n_micro
        # ticks in all.
        n_ticks = 2 * (n_stages - 1) + n_micro
        held, to_send = zero, zero
        for t in range(n_ticks):
            sent = torch.empty_like(zero)
            reqs = _exchange(to_send, sent, group, axis, sid,
                             n_stages)  # drain
            x = inject(t) if first else held
            y = stage_fn(params, x)                                # fill
            _wait(reqs)
            held, to_send = sent, y
            outs.append(y if last else zero)
        outs = torch.stack(outs)[2 * (n_stages - 1):
                                 2 * (n_stages - 1) + n_micro]
    return sharding.from_local(outs[None], mesh,
                               _on_dim0(outs.dim() + 1, axis))


def _on_dim0(ndim: int, axis: str) -> P:
    """A rank-``ndim`` spec split over ``axis`` on dimension 0."""
    return P(axis, *([None] * (ndim - 1)))


def pipeline_reference(stage_fn, stage_params, microbatches, n_stages):
    """Oracle: each microbatch through every stage in order, no mesh."""
    outs = []
    for x in microbatches:
        for s in range(n_stages):
            x = stage_fn(tree.map_leaves(lambda a: a[s], stage_params), x)
        outs.append(x)
    return torch.stack(outs)
