"""The train, decode and prefill step functions (``src/repro/train/
train_step.py:15-78``).

PyTorch runs eagerly, so a step is a plain function: no jit, no donated
buffers.  The sharding trees of the JAX module belong to the parallelism
slice.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models.model import Model
from repro_torch.train import tree
from repro_torch.train.optimizer import AdamW


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
