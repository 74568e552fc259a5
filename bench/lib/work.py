"""Operations and bytes a kernel or a layer needs on given inputs, from
their shapes alone: a frozen copy of ``chip_smoke.py``'s ``work`` (paged
attention), and the mixture-of-experts layer's under the port's routing
rule (FIFO capacity ``max(int(t k 1.25 / E), 1)``).  Each input byte is
counted once and each output byte once, whatever a kernel reads again;
where the work depends on the data, what these inputs need."""
from __future__ import annotations

from typing import Tuple

import numpy as np


def paged_work(B: int, T: int, H: int, hd: int, hkv: int, block_numel: int,
               lens, kv_lens=None, itemsize: int = 2) -> Tuple[int, int]:
    """(bytes, flops) of one paged-attention call: q and out, the block
    table, lens and kv_lens once each, the K/V of every position below
    each row's key end min(lens, kv_lens) once per kv head; two hd-long
    dot products per (query head, visible key), query t of a row seeing
    keys up to n - T + t."""
    lens = np.asarray(lens, np.int64)
    kv = lens if kv_lens is None else np.asarray(kv_lens, np.int64)
    ends = np.maximum(0, np.minimum(lens, kv))
    nbytes = (2 * B * T * H * hd * itemsize
              + int(ends.sum()) * hkv * hd * 2 * itemsize
              + block_numel * 4 + B * 4 * (1 if kv_lens is None else 2))
    t = np.arange(T)[None, :]
    visible = np.maximum(0, np.minimum(ends[:, None],
                                       lens[:, None] - T + t + 1)).sum()
    return int(nbytes), int(4 * hd * H * int(visible))


def capacity(t: int, top_k: int, capacity_factor: float, E: int) -> int:
    """Slots per expert: ``int(t * top_k * capacity_factor / E)``, at
    least 1."""
    return max(int(t * top_k * capacity_factor / E), 1)


def fifo_keep(eids: np.ndarray, E: int, C: int) -> np.ndarray:
    """eids [t, k] -> kept [t, k] bool: choice ``token * k + rank`` keeps
    its expert's slot when fewer than ``C`` earlier choices went to that
    expert (FIFO by token id, then by rank)."""
    flat = eids.reshape(-1)
    onehot = np.zeros((flat.size, E), np.int32)
    onehot[np.arange(flat.size), flat] = 1
    before = np.cumsum(onehot, axis=0) - onehot
    return (before[np.arange(flat.size), flat] < C).reshape(eids.shape)


def moe_work(eids: np.ndarray, d: int, f: int, E: int, C: int,
             itemsize: int = 2) -> Tuple[int, int]:
    """(bytes, flops) one expert layer needs for the choices ``eids`` [t,
    k] of its call: the router, the three matrices of each expert that
    receives a kept choice, the activations in and out; the router's
    product and three d x f products per kept choice."""
    t = eids.shape[0]
    keep = fifo_keep(eids, E, C)
    hit = np.unique(eids[keep]).size
    nbytes = (d * E + hit * 3 * d * f + 2 * t * d) * itemsize
    flops = 2 * t * d * E + int(keep.sum()) * 3 * 2 * d * f
    return int(nbytes), int(flops)
