"""Plain float32 building blocks the references share: RMSNorm, rotary
embedding (rotate-half, as GPT-NeoX and Llama), causal grouped-query
softmax attention, the SwiGLU MLP, and the fake-fp8 quantizer the
control runs through.  Plain ``torch`` only: nothing of the program."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0          # the largest finite float8 e4m3 value


def strict_f32() -> None:
    """Float32 products in float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


class Exact:
    """Operands as they are (the reference)."""

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        return w


class FakeFp8(Exact):
    """Operands rounded to float8 e4m3 and back: activations with one
    scale a row, weights one a column (output channel), each scale the
    absolute maximum over 448.  The control: the step below the
    configuration's bfloat16."""

    @staticmethod
    def _q(x: torch.Tensor, dim: int) -> torch.Tensor:
        s = (x.detach().abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
             / FP8_MAX)
        q = (x.detach() / s).to(torch.float8_e4m3fn).float() * s
        return x + (q - x.detach())        # the gradient passes straight

    def act(self, x):
        return self._q(x, -1)

    def weight(self, w):
        return self._q(w, 0)


def linear(x: torch.Tensor, w: torch.Tensor, quant=Exact()) -> torch.Tensor:
    """x [..., n] @ w (any stored dtype) viewed as [n, m], in float32."""
    w2 = w.reshape(x.shape[-1], -1).float()
    return quant.act(x) @ quant.weight(w2)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
        * scale.float()


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x [T, H, hd], pos [T]: rotate-half rotary embedding, frequencies
    theta^(-i / (hd / 2))."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = pos.float()[:, None] * freq
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     block: int = 1024) -> torch.Tensor:
    """q [T, H, hd], k/v [T, Hkv, hd] -> [T, H, hd]: softmax(q k / sqrt
    hd) over keys at or before each query; query head h reads kv head
    h // (H / Hkv).  Queries in blocks, so the scores stay small."""
    T, H, hd = q.shape
    Hkv = k.shape[1]
    g = H // Hkv
    kk = k.permute(1, 0, 2)                          # [Hkv, T, hd]
    vv = v.permute(1, 0, 2)
    out = []
    for a in range(0, T, block):
        b = min(T, a + block)
        qb = q[a:b].reshape(b - a, Hkv, g, hd).permute(1, 2, 0, 3)
        s = torch.matmul(qb, kk[:, None].transpose(-1, -2)) / math.sqrt(hd)
        keep = (torch.arange(T, device=q.device)[None, :]
                <= torch.arange(a, b, device=q.device)[:, None])
        s = s.masked_fill(~keep, float("-inf"))
        o = torch.matmul(torch.softmax(s, dim=-1), vv[:, None])
        out.append(o.permute(2, 0, 1, 3).reshape(b - a, H, hd))
    return torch.cat(out)


def swiglu(h: torch.Tensor, w_gate, w_up, w_down, quant=Exact()
           ) -> torch.Tensor:
    return linear(F.silu(linear(h, w_gate, quant)) * linear(h, w_up, quant),
                  w_down, quant)
