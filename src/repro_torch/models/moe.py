"""Mixture-of-experts layer (olmoe, arctic): the single-device path of the
JAX package's ``models/moe.py``.

Token-choice top-k routing with a per-expert capacity, computed densely
at capacity: every expert's ``C`` slots are filled in token order, the
choices past them are dropped, and the products are ``[E, C, d] x [E, d,
f]`` batched matrix products, which the reference also leaves outside
Pallas.  Every token of the dispatch routes, idle and padded rows
included, and claims capacity like any other: a row's output depends on
the rows before it in the dispatch, in both packages.

The reference's expert-parallel ``shard_map`` path waits for the port's
parallelism slice; :func:`moe_block` refuses a mesh.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.models.config import ModelConfig


def _capacity(num_tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert: ``int(t * top_k * capacity_factor / E)``, at
    least 1 (``moe.py:48-51`` of the JAX package, truncation included)."""
    mo = cfg.moe
    c = int(num_tokens * mo.top_k * mo.capacity_factor / mo.num_experts)
    return max(c, 1)


def _route(cfg: ModelConfig, x: torch.Tensor, router_w: torch.Tensor):
    """x [t, d] -> (gates [t, k] f32, expert ids [t, k] int64, aux loss).

    f32 router logits and softmax; the top k by a stable descending sort,
    so a tie goes to the lower expert id as ``jax.lax.top_k`` gives it
    (``torch.topk`` does not promise an order); gates renormalised to sum
    to 1; the Switch load-balance loss ``E * sum(mean prob * fraction of
    first choices)``."""
    mo = cfg.moe
    logits = torch.matmul(x.float(), router_w.float())
    probs = torch.softmax(logits, dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = order.values[:, :mo.top_k]
    eids = order.indices[:, :mo.top_k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    density = probs.mean(0)                                          # [E]
    frac = F.one_hot(eids[:, 0], mo.num_experts).float().mean(0)
    aux = mo.num_experts * torch.sum(density * frac)
    return gates, eids, aux


def _expert_compute(cfg: ModelConfig, x: torch.Tensor, gates, eids,
                    w_gate, w_up, w_down) -> torch.Tensor:
    """Dense-at-capacity compute of all E experts.  x: [t, d] -> [t, d].

    Choice i = token * k + rank takes position ``pos`` in its expert's
    queue: the number of earlier choices for that expert (an exclusive
    cumsum over the one-hot, so FIFO by token id, then by rank).  Choices
    at ``pos >= C`` are dropped and sent to a sentinel slot ``E * C``
    that every dropped choice shares and that is sliced off; kept choices
    have slots of their own.  Empty slots hold a zero row."""
    t, d = x.shape
    k, E = cfg.moe.top_k, cfg.moe.num_experts
    C = _capacity(t, cfg)
    eids_f = eids.reshape(-1)                                    # [t*k]
    gates_f = gates.reshape(-1)
    onehot = F.one_hot(eids_f, E)                                # int64
    # The exclusive cumsum down the choices, taken along the inner
    # dimension of the transpose: CUDA scans an outer dimension one
    # thread per column (0.76 ms a layer at t*k = 4096 on an H100).
    pos = torch.cumsum(onehot.t(), dim=1).t() - onehot
    pos_sel = pos.gather(1, eids_f[:, None])[:, 0]
    keep = pos_sel < C
    slot = torch.where(keep, eids_f * C + pos_sel, E * C)        # sentinel

    # Dispatch: the token of each slot (t = the zero pad row), gathered.
    token_ids = torch.arange(t * k, device=x.device) // k
    slot_token = torch.full((E * C + 1,), t, dtype=torch.long,
                            device=x.device)
    slot_token[slot] = torch.where(keep, token_ids, t)
    x_pad = torch.cat([x, x.new_zeros(1, d)])
    xe = x_pad[slot_token[:-1]].view(E, C, d)

    h = F.silu(torch.bmm(xe, w_gate)) * torch.bmm(xe, w_up)
    ye = torch.bmm(h, w_down)                                    # [E, C, d]

    # Combine: each kept choice's output, weighted by its gate.
    ye_flat = torch.cat([ye.reshape(E * C, d), ye.new_zeros(1, d)])
    y_choice = torch.where(keep[:, None], ye_flat[slot], 0)
    return (y_choice * gates_f[:, None].to(y_choice.dtype)).view(
        t, k, d).sum(1)


def _moe_local(cfg: ModelConfig, x: torch.Tensor, p: Dict[str, Any]):
    """The single-device path: x [B, T, D] -> (out [B, T, D], aux)."""
    B, T, D = x.shape
    xf = x.reshape(B * T, D)
    gates, eids, aux = _route(cfg, xf, p["router"])
    out = _expert_compute(cfg, xf, gates, eids, p["wi_gate"], p["wi_up"],
                          p["wo"])
    return out.view(B, T, D), aux


def moe_block(p: Dict[str, Any], cfg: ModelConfig, x: torch.Tensor,
              mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, T, D] -> (out [B, T, D], aux loss scalar f32), under the
    profiler range ``moe.block``."""
    if mesh is not None:
        raise NotImplementedError(
            "expert parallelism over a mesh is not ported yet (ROADMAP: "
            "parallelism)")
    with record_function("moe.block"):
        return _moe_local(cfg, x, p)
