"""The train, decode and prefill step functions and their sharding
trees (``src/repro/train/train_step.py``).

PyTorch runs eagerly, so a step is a plain function: no jit, no donated
buffers.  Under a mesh the same step runs on DTensors: the sharding trees
below (:class:`~repro_torch.parallel.sharding.NamedSharding` per leaf,
the JAX module's ``in_shardings``) place the parameters, the optimizer
state and the batch, and the gradients are reduced to their parameters'
placements before the update.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models.model import Model
from repro_torch.parallel import sharding as shlib
from repro_torch.parallel.sharding import NamedSharding, PartitionSpec as P
from repro_torch.train import tree
from repro_torch.train.optimizer import AdamW, zero_shard_spec


def loss_and_grads(model: Model, params, batch: Dict[str, torch.Tensor]):
    """-> (loss, metrics, grads): gradients by ``torch.autograd.grad``
    over the parameter leaves, each given ``requires_grad`` on a detached
    alias (the caller's tensors are not touched)."""
    leaves, spec = tree.flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    loss, metrics = model.loss(tree.unflatten(spec, leaves), batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    # Under a mesh: the gradient of a parameter comes back partial over
    # the axes its inputs were split on; reduce it to the parameter's own
    # placements (the all-reduce / reduce-scatter GSPMD inserts).
    grads = [g.redistribute(p.device_mesh, p.placements)
             if shlib.is_dtensor(g) and g.placements != p.placements else g
             for p, g in zip(leaves, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree.unflatten(spec, grads))


def make_train_step(model: Model, opt: AdamW, microbatches: int = 1):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    ``microbatches > 1`` splits the batch's leading dim and accumulates
    the gradients in float32, divided by the count; the loss is the mean
    over microbatches and the other metrics the last microbatch's."""

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            loss, metrics, grads = loss_and_grads(model, params, batch)
        else:
            b = next(iter(batch.values())).shape[0]
            if b % microbatches:
                raise ValueError(f"batch {b} is not a multiple of "
                                 f"{microbatches} microbatches")
            mbs = [{k: x.reshape((microbatches, b // microbatches)
                                 + tuple(x.shape[1:]))[i]
                    for k, x in batch.items()} for i in range(microbatches)]
            grads = tree.map_leaves(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)
            losses = []
            for mb in mbs:
                mb_loss, metrics, g = loss_and_grads(model, params, mb)
                grads = tree.map_leaves(lambda a, x: a + x.float(), grads, g)
                losses.append(mb_loss.float())
            grads = tree.map_leaves(lambda g: g / microbatches, grads)
            loss = sum(losses) / microbatches
        new_params, new_state, opt_metrics = opt.update(grads, opt_state,
                                                        params)
        metrics = {**metrics, **opt_metrics, "loss": loss}
        return new_params, new_state, metrics

    return train_step


def make_decode_step(model: Model):
    """serve_step: one new token against a filled KV cache."""

    def serve_step(params, caches, tokens, pos):
        return model.decode_step(params, caches, tokens, pos)

    return serve_step


def make_prefill(model: Model, max_len: int):
    """prefill: the prompt's cache and first token; ``extras`` (images
    or audio frames) conditions the cross-attention families."""

    def prefill(params, tokens, extras=None):
        return model.prefill(params, tokens, max_len, extras=extras)

    return prefill


# ---------------------------------------------------------------------------
# Sharding trees (``train_step.py:78-142`` there).  Each needs the rules
# context (``axis_rules``) of ``mesh``; each leaf is a NamedSharding.
# ---------------------------------------------------------------------------
def abstract_params(model: Model) -> Any:
    """The parameter tree as fake tensors (shapes and dtypes, no
    storage), drawn by a CPU copy of ``model`` under ``FakeTensorMode``:
    the counterpart of ``jax.eval_shape(model.init, key)``."""
    import dataclasses

    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(allow_non_fake_inputs=True):
        cpu = dataclasses.replace(model, device=torch.device("cpu"))
        return cpu.init(torch.Generator().manual_seed(0))


def param_shardings(model: Model, mesh) -> Any:
    return shlib.shardings_tree(model.param_axes())


def opt_state_shardings(model: Model, opt: AdamW, mesh, params_abs) -> Any:
    """m/v get the parameters' spec plus the ZeRO ``data`` axis on a
    divisible dimension.  ``params_abs``: any tree of tensors of the
    parameters' shapes (``meta`` ones will do)."""
    specs = shlib.specs_tree(opt.state_axes(model.param_axes()))
    state = opt.init(tree.map_leaves(
        lambda p: torch.empty(p.shape, dtype=p.dtype, device="meta"),
        params_abs))                  # shapes only: nothing is allocated
    leaves, spec = tree.flatten(specs, lambda x: isinstance(x, P))
    shapes = tree.flatten(state)[0]
    return tree.unflatten(spec, [
        NamedSharding(mesh, zero_shard_spec(s, tuple(x.shape), mesh))
        for s, x in zip(leaves, shapes)])


def _batch_axes(mesh):
    names = shlib.mesh_axis_names(mesh)
    axes = tuple(a for a in ("pod", "data") if a in names)
    n = 1
    for a in axes:
        n *= shlib.mesh_axis_size(mesh, a)
    return axes, n


def batch_shardings(mesh, batch_specs) -> Any:
    """The leading (batch) dimension over pod+data when divisible.
    ``batch_specs``: a tree of tensors (or anything with ``shape``)."""
    axes, bsz = _batch_axes(mesh)

    def one(leaf):
        shape = tuple(leaf.shape)
        if not shape or shape[0] % bsz or not axes:
            return NamedSharding(mesh, P())
        return NamedSharding(mesh, P(axes, *([None] * (len(shape) - 1))))

    return tree.map_leaves(one, batch_specs)


def cache_shardings(mesh, cache_abs, cfg) -> Any:
    """KV caches: the first dimension a multiple of the batch axes' size
    gets them, then the largest remaining dimension divisible by the
    model axis gets ``model`` (the JAX module's heuristic)."""
    axes, bsz = _batch_axes(mesh)
    msz = shlib.mesh_axis_size(mesh, "model")

    def one(leaf):
        dims = list(leaf.shape)
        entries = [None] * len(dims)
        for i, d in enumerate(dims):
            if axes and d % bsz == 0 and d >= bsz and entries[i] is None:
                entries[i] = axes
                break
        for i in sorted(range(len(dims)), key=lambda i: -dims[i]):
            if entries[i] is None and dims[i] % msz == 0 and dims[i] >= msz:
                entries[i] = "model"
                break
        return NamedSharding(mesh, P(*entries))

    return tree.map_leaves(one, cache_abs)
