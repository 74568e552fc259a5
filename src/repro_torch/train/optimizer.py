"""AdamW with optional 8-bit (row-quantized) first and second moments.

As ``src/repro/train/optimizer.py:25-146``: global-norm clipping, a
cosine schedule with linear warmup, decoupled weight decay on matrices
(ndim >= 2), and ``state_dtype="int8"`` moments quantized per row by
absmax.  ``update`` is functional: it returns new tensors and writes
none of its arguments, so a state handed to the async checkpointer is
never changed under it.  The ZeRO sharding specs (``zero_shard_spec``,
``state_axes``) belong to the parallelism slice.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch
from torch.profiler import record_function

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

        def step_of(p, g, m, v):
            g = g.float() * scale
            m_f = _dequantize(m) if quant else m
            v_f = _dequantize(v) if quant else v
            m_f = c.b1 * m_f + (1 - c.b1) * g
            v_f = c.b2 * v_f + (1 - c.b2) * torch.square(g)
            delta = (m_f / b1c) / (torch.sqrt(v_f / b2c) + c.eps)
            if p.dim() >= 2:     # decoupled weight decay on matrices only
                delta = delta + c.weight_decay * p.float()
            new_p = (p.float() - lr * delta).to(p.dtype)
            if quant:
                return new_p, _quantize(m_f), _quantize(v_f)
            return new_p, m_f, v_f

        def upd(p, g, m, v):
            """``step_of`` over row blocks of a large matrix leaf, into
            preallocated outputs: the same elementwise arithmetic, so the
            same bits, with its float32 temporaries bounded by
            ``_CHUNK_ELEMS``."""
            if quant or p.dim() < 2 or p.numel() <= _CHUNK_ELEMS:
                return step_of(p, g, m, v)
            rows = p.numel() // p.shape[-1]
            per = max(1, _CHUNK_ELEMS // p.shape[-1])
            ins = [x.reshape(rows, -1) for x in (p, g, m, v)]
            outs = [torch.empty_like(x) for x in (ins[0], ins[2], ins[3])]
            for a in range(0, rows, per):
                for out, x in zip(outs, step_of(*(t[a:a + per]
                                                  for t in ins))):
                    out[a:a + per] = x
            return tuple(x.reshape(p.shape) for x in outs)

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
