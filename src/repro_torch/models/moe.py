"""Mixture-of-experts layer (olmoe, arctic) with expert parallelism
(the JAX package's ``models/moe.py``).

Token-choice top-k routing with a per-expert capacity, computed densely
at capacity: every expert's ``C`` slots are filled in token order, the
choices past them are dropped, and the products are ``[E, C, d] x [E, d,
f]`` batched matrix products, which the reference also leaves outside
Pallas.  Every token of the dispatch routes, idle and padded rows
included, and claims capacity like any other: a row's output depends on
the rows before it in the dispatch, in both packages.

Under a rules context (``parallel.sharding.axis_rules``) the layer takes
the expert-parallel route on local shards (``shard_map_compat``): every
``model`` column routes the same tokens, all-gathers its experts' weights
over ``data`` just in time (ZeRO-3), computes the choices that land on
its ``e_local`` experts from ``base`` on, and the columns' partial
outputs meet in one all-reduce over ``model``; ``aux`` is averaged over
the batch axes.  Each expert column fills only the slots addressed to
it: the paper's fan-in of client endpoints into a server's receive
queue, with slot-disjoint writes instead of a lock.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.models.config import ModelConfig
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import P


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
                    w_gate, w_up, w_down, base: int = 0,
                    e_local: int = None) -> torch.Tensor:
    """Dense-at-capacity compute of the ``e_local`` experts from ``base``
    on (all E by default).  x: [t, d] -> [t, d].

    Choice i = token * k + rank takes position ``pos`` in its expert's
    queue: the number of earlier choices for that expert (an exclusive
    cumsum over the one-hot, so FIFO by token id, then by rank).  Choices
    at ``pos >= C`` are dropped and sent to a sentinel slot ``E * C``
    that every dropped choice shares and that is sliced off; kept choices
    have slots of their own.  Empty slots hold a zero row.  Choices for
    experts outside this shard's range go to an overflow bucket
    ``e_local`` and are dropped the same way."""
    t, d = x.shape
    k = cfg.moe.top_k
    E = cfg.moe.num_experts if e_local is None else e_local
    C = _capacity(t, cfg)
    eids_f = eids.reshape(-1)                                    # [t*k]
    gates_f = gates.reshape(-1)
    local = None
    if e_local is not None:
        local = (eids_f >= base) & (eids_f < base + E)
        eids_f = torch.where(local, eids_f - base, E)
        onehot = F.one_hot(eids_f, E + 1)
    else:
        onehot = F.one_hot(eids_f, E)                            # int64
    # The exclusive cumsum down the choices, taken along the inner
    # dimension of the transpose: CUDA scans an outer dimension one
    # thread per column (0.76 ms a layer at t*k = 4096 on an H100).
    pos = torch.cumsum(onehot.t(), dim=1).t() - onehot
    pos_sel = pos.gather(1, eids_f[:, None])[:, 0]
    keep = pos_sel < C if local is None else local & (pos_sel < C)
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


def moe_block(p: Dict[str, Any], cfg: ModelConfig, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, T, D] -> (out [B, T, D], aux loss scalar f32), under the
    profiler range ``moe.block``: the expert-parallel route under a rules
    context, else the single-device one."""
    with record_function("moe.block"):
        if not sharding.active():
            return _moe_local(cfg, x, p)
        return _moe_expert_parallel(cfg, x, p, sharding.current_mesh())


def _moe_expert_parallel(cfg: ModelConfig, x: torch.Tensor,
                         p: Dict[str, Any], mesh):
    """The expert-parallel route (``moe.py:124-168`` of the JAX package):
    experts split over ``model``, their weights also over ``data``
    (``expert_data``), tokens over the batch axes when divisible."""
    import torch.distributed._functional_collectives as funcol
    names = sharding.mesh_axis_names(mesh)
    E, msz = cfg.moe.num_experts, sharding.mesh_axis_size(mesh, "model")
    if E % msz:
        raise ValueError(f"expert parallelism: {E} experts do not split "
                         f"over a model axis of {msz} on this mesh")
    e_local = E // msz
    batch_axes = tuple(a for a in ("pod", "data") if a in names)
    bsz = 1
    for a in batch_axes:
        bsz *= sharding.mesh_axis_size(mesh, a)
    batch_spec = batch_axes if (batch_axes and x.shape[0] % bsz == 0) \
        else None
    data_ax = "data" if "data" in names else None

    def local_fn(x_loc, router_w, w_gate, w_up, w_down):
        Bl, Tl, Dl = x_loc.shape
        xf = x_loc.reshape(Bl * Tl, Dl)
        gates, eids, aux = _route(cfg, xf, router_w)
        if data_ax is not None:
            # ZeRO-3: gather the expert weights split over data.
            grp = mesh.get_group(data_ax)
            w_gate = funcol.all_gather_tensor_autograd(w_gate, 1, grp)
            w_up = funcol.all_gather_tensor_autograd(w_up, 1, grp)
            w_down = funcol.all_gather_tensor_autograd(w_down, 2, grp)
        base = mesh.get_local_rank("model") * e_local
        out = _expert_compute(cfg, xf, gates, eids, w_gate, w_up, w_down,
                              base, e_local)
        out = sharding.psum(out, mesh, "model")
        if batch_spec:
            for a in batch_axes:
                aux = sharding.psum(aux, mesh, a)
            aux = aux / bsz
        return out.reshape(Bl, Tl, Dl), aux

    wspec_in = P("model", data_ax, None)
    wspec_out = P("model", None, data_ax)
    return sharding.shard_map_compat(
        local_fn, mesh=mesh,
        in_specs=(P(batch_spec, None, None), P(None, None),
                  wspec_in, wspec_in, wspec_out),
        out_specs=(P(batch_spec, None, None), P()),
        collective_axes=names,
    )(x, p["router"], p["wi_gate"], p["wi_up"], p["wo"])
