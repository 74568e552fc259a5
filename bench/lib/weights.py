"""The weights of a run, drawn by the benchmark from ``--seed`` on the
device, in the type they are served in, one call a leaf.  Both the
program and the reference are handed these tensors; the reference never
reads weights the program made.

``layout`` (the reference module's) lists (path, shape, init): a normal
of the given standard deviation, or a norm scale (1 + 0.1 normal, so a
misapplied scale shows in the comparison)."""
from __future__ import annotations

from typing import Dict

import torch

NORM_JITTER = 0.1


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def draw(layout, seed: int, device, dtype=torch.bfloat16) -> Dict:
    g = generator(seed, device)
    tree: Dict = {}
    for path, shape, init in layout:
        t = torch.empty(shape, dtype=dtype, device=device)
        if init[0] == "normal":
            t.normal_(0.0, init[1], generator=g)
        elif init[0] == "norm":
            t.normal_(1.0, NORM_JITTER, generator=g)
        else:
            raise ValueError(f"unknown init {init!r}")
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return tree


def leaves(tree, prefix=()):
    """[(path, tensor)] in sorted-key order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += leaves(tree[k], prefix + (k,))
        return out
    return [(prefix, tree)]
