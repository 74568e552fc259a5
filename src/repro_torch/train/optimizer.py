"""AdamW with optional 8-bit (row-quantized) first and second moments.

As ``src/repro/train/optimizer.py:25-146``: global-norm clipping, a
cosine schedule with linear warmup, decoupled weight decay on matrices
(ndim >= 2), and ``state_dtype="int8"`` moments quantized per row by
absmax.  ``update`` is functional: it returns new tensors and writes
none of its arguments, so a state handed to the async checkpointer is
never changed under it.

ZeRO-1 (``optimizer.py:81-92,149-168`` there): :meth:`AdamW.state_axes`
gives the state the parameters' logical axes (the int8 ``{q, scale}``
form included) and :func:`zero_shard_spec` adds the ``data`` axis on the
first divisible unsharded dimension, so the moments are split over data
and model.  Under a mesh a float32-state matrix leaf is updated on this
rank's shard in the moments' placements (its gradient reduce-scattered
there, the new parameter all-gathered back), in the same row blocks as a
plain leaf; vectors and int8 state run on DTensors, which insert the
gathers and reductions GSPMD would.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch
from torch.profiler import record_function

from repro_torch.parallel.sharding import Axes, PartitionSpec, map_axes
from repro_torch.parallel.sharding import full, is_dtensor, mesh_axis_names
from repro_torch.parallel.sharding import mesh_axis_size
from repro_torch.train import tree


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    state_dtype: str = "float32"     # "float32" | "int8"


# ---------------------------------------------------------------------------
# int8 quantization (row absmax over the last axis)
# ---------------------------------------------------------------------------
def _quantize(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Round half to even (``torch.round``, as ``jnp.round``)."""
    squeeze = x.dim() == 0
    if squeeze:
        x = x[None]
    absmax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    scale = torch.clamp(absmax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    if squeeze:
        q, scale = q[0], scale[0]
    return {"q": q, "scale": scale.float()}


def _dequantize(s: Dict[str, torch.Tensor]) -> torch.Tensor:
    return s["q"].float() * s["scale"]


def _is_state_leaf(x: Any) -> bool:
    return isinstance(x, dict) and "q" in x


# Elements one pass of the update takes from a large matrix leaf.  A
# whole stacked leaf at once would need several float32 temporaries of its
# full size (zamba2-2.7b's stacked ``in_proj``: 1.44e9 elements, 5.8 GB
# each) beside the old and the new state, more than one 80 GB card holds.
_CHUNK_ELEMS = 1 << 26


class AdamW:
    def __init__(self, cfg: OptConfig):
        self.cfg = cfg

    def init(self, params) -> Dict[str, Any]:
        quant = self.cfg.state_dtype == "int8"

        def zeros_like_state(p):
            z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            return _quantize(z) if quant else z

        device = tree.flatten(params)[0][0].device
        return {"step": torch.zeros((), dtype=torch.int32, device=device),
                "m": tree.map_leaves(zeros_like_state, params),
                "v": tree.map_leaves(zeros_like_state, params)}

    def state_axes(self, param_axes) -> Dict[str, Any]:
        """The Axes tree matching :meth:`init`'s: each moment takes its
        parameter's axes; an int8 moment's ``scale`` (one per row) its
        parameter's axes with the last one ``None``."""
        def per_param(a: Axes):
            if self.cfg.state_dtype == "int8":
                names = a.names if a.names else (None,)
                return {"q": Axes(*names),
                        "scale": Axes(*(names[:-1] + (None,)))}
            return a

        m = map_axes(per_param, param_axes)
        return {"step": Axes(), "m": m, "v": m}

    def schedule(self, step: torch.Tensor) -> torch.Tensor:
        """Learning rate at ``step`` (a tensor): linear warmup, then a
        cosine from lr down to 0.1 lr at ``total_steps``."""
        c = self.cfg
        s = step.float()
        warm = torch.clamp(s / max(c.warmup_steps, 1), max=1.0)
        t = torch.clamp((s - c.warmup_steps)
                        / max(c.total_steps - c.warmup_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return c.lr * warm * (0.1 + 0.9 * cos)

    def update(self, grads, state, params):
        """-> (new params, new state, {"grad_norm", "lr"}); all on the
        device, no host sync."""
        with record_function("adamw.update"):
            return self._update(grads, state, params)

    def _update(self, grads, state, params):
        c = self.cfg
        step = state["step"] + 1
        flat_p, spec = tree.flatten(params)
        flat_g = tree.flatten(grads)[0]
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                               for g in flat_g))
        scale = torch.clamp(c.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        lr = self.schedule(step)
        b1c = 1 - torch.pow(c.b1, step.float())
        b2c = 1 - torch.pow(c.b2, step.float())
        quant = c.state_dtype == "int8"

        def step_of(p, g, m, v, k=(scale, lr, b1c, b2c)):
            scale_, lr_, b1c_, b2c_ = k
            g = g.float() * scale_
            m_f = _dequantize(m) if quant else m
            v_f = _dequantize(v) if quant else v
            m_f = c.b1 * m_f + (1 - c.b1) * g
            v_f = c.b2 * v_f + (1 - c.b2) * torch.square(g)
            delta = (m_f / b1c_) / (torch.sqrt(v_f / b2c_) + c.eps)
            if p.dim() >= 2:     # decoupled weight decay on matrices only
                delta = delta + c.weight_decay * p.float()
            new_p = (p.float() - lr_ * delta).to(p.dtype)
            if quant:
                return new_p, _quantize(m_f), _quantize(v_f)
            return new_p, m_f, v_f

        def blocks(p, g, m, v, k=(scale, lr, b1c, b2c)):
            """``step_of`` over row blocks of a large matrix, into
            preallocated outputs: the same elementwise arithmetic, so the
            same bits, with its float32 temporaries bounded by
            ``_CHUNK_ELEMS``."""
            if p.numel() <= _CHUNK_ELEMS:
                return step_of(p, g, m, v, k)
            rows = p.numel() // p.shape[-1]
            per = max(1, _CHUNK_ELEMS // p.shape[-1])
            ins = [x.reshape(rows, -1) for x in (p, g, m, v)]
            outs = [torch.empty_like(x) for x in (ins[0], ins[2], ins[3])]
            for a in range(0, rows, per):
                for out, x in zip(outs, step_of(*(t[a:a + per]
                                                  for t in ins), k)):
                    out[a:a + per] = x
            return tuple(x.reshape(p.shape) for x in outs)

        def on_shards(p, g, m, v):
            """A DTensor leaf: ``blocks`` on this rank's shard in the
            moments' placements (the parameter's plus the ZeRO axis:
            ``g`` reduce-scattered, ``p`` cut locally), the new parameter
            gathered back to its own placements.  The temporaries are
            bounded by the shard, and each element's arithmetic is the
            same."""
            from torch.distributed.tensor import DTensor
            mesh, pl = m.device_mesh, m.placements
            loc = [x.redistribute(mesh, pl).to_local() for x in (p, g, m, v)]
            out = blocks(*loc, k=tuple(full(t) for t in (scale, lr, b1c,
                                                         b2c)))
            new = [DTensor.from_local(t, mesh, pl, run_check=False,
                                      shape=m.shape, stride=m.stride())
                   for t in out]
            return (new[0].redistribute(mesh, p.placements),) + tuple(new[1:])

        def upd(p, g, m, v):
            if quant or p.dim() < 2:
                return step_of(p, g, m, v)
            if is_dtensor(p):
                return on_shards(p, g, m, v)
            return blocks(p, g, m, v)

        is_leaf = _is_state_leaf if quant else None
        flat_m = tree.flatten(state["m"], is_leaf)[0]
        flat_v = tree.flatten(state["v"], is_leaf)[0]
        out = [upd(p, g, m, v)
               for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v)]
        new_params = tree.unflatten(spec, [o[0] for o in out])
        new_m = tree.unflatten(spec, [o[1] for o in out])
        new_v = tree.unflatten(spec, [o[2] for o in out])
        return new_params, {"step": step, "m": new_m, "v": new_v}, {
            "grad_norm": gnorm, "lr": lr}


def zero_shard_spec(spec: PartitionSpec, shape, mesh,
                    zero_axis: str = "data") -> PartitionSpec:
    """Add the ZeRO axis to the first divisible, unsharded dimension
    (unchanged when the mesh lacks the axis or the spec already uses
    it)."""
    if zero_axis not in mesh_axis_names(mesh):
        return spec
    size = mesh_axis_size(mesh, zero_axis)
    used = set()
    for e in spec:
        if isinstance(e, str):
            used.add(e)
        elif isinstance(e, tuple):
            used.update(e)
    if zero_axis in used:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for i, (e, dim) in enumerate(zip(entries, shape)):
        if e is None and dim % size == 0 and dim >= size:
            entries[i] = zero_axis
            return PartitionSpec(*entries)
    return spec
