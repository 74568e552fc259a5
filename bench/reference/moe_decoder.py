"""Plain float32 reference of a mixture-of-experts decoder with a dense
residual MLP (Snowflake Arctic: each layer's attention, then top-k
routed experts beside a dense MLP, both on the same normed input, added
to the residual together).

Per layer: RMSNorm; grouped-query attention with rotary embedding; the
residual; RMSNorm; the router's float32 logits and softmax, the top k
experts by probability with their gates renormalized to sum to 1; each
expert a SwiGLU MLP; the dense SwiGLU MLP; the residual.  Final RMSNorm,
an untied LM head.  The experts' capacity (which choices are kept) is
decided by the caller's ``route``: under capacity a row's kept choices
depend on the other rows of its dispatch, which the serving check
supplies (``lib/serve_check.py``).

Departures from the published model, as the configuration states it:
RMSNorm epsilon 1e-6 (Arctic's config: 1e-5); random weights; the
capacity rule ``max(int(t k 1.25 / E), 1)`` with FIFO order by row, the
configuration's, where the published model serves without dropping."""
from __future__ import annotations

from typing import Callable, List, Sequence

import torch

from bench.reference.common import (Exact, causal_attention, linear,
                                    rms_norm, rope, swiglu)


def layout(c: dict) -> list:
    """(path, shape, init) of every weight, in the draw's order."""
    L, d, H, Hkv, hd = (c["num_layers"], c["d_model"], c["num_heads"],
                        c["num_kv_heads"], c["head_dim"])
    f, V, E, fe = c["d_ff"], c["vocab_size"], c["num_experts"], \
        c["d_ff_expert"]
    n = ("normal",)
    return [
        (("embed", "table"), (V, d), n + (1.0,)),
        (("embed", "unembed"), (d, V), n + (d ** -0.5,)),
        (("layers", "ln1"), (L, d), ("norm",)),
        (("layers", "attn", "wq"), (L, d, H, hd), n + (d ** -0.5,)),
        (("layers", "attn", "wk"), (L, d, Hkv, hd), n + (d ** -0.5,)),
        (("layers", "attn", "wv"), (L, d, Hkv, hd), n + (d ** -0.5,)),
        (("layers", "attn", "wo"), (L, H, hd, d), n + ((H * hd) ** -0.5,)),
        (("layers", "ln2"), (L, d), ("norm",)),
        (("layers", "moe", "router"), (L, d, E), n + (d ** -0.5,)),
        (("layers", "moe", "wi_gate"), (L, E, d, fe), n + (d ** -0.5,)),
        (("layers", "moe", "wi_up"), (L, E, d, fe), n + (d ** -0.5,)),
        (("layers", "moe", "wo"), (L, E, fe, d), n + (fe ** -0.5,)),
        (("layers", "dense", "wi_gate"), (L, d, f), n + (d ** -0.5,)),
        (("layers", "dense", "wi_up"), (L, d, f), n + (d ** -0.5,)),
        (("layers", "dense", "wo"), (L, f, d), n + (f ** -0.5,)),
        (("final_norm",), (d,), ("norm",)),
    ]


def router_logits(W, c, layer: int, h: torch.Tensor) -> torch.Tensor:
    return h @ W["layers"]["moe"]["router"][layer].float()


def forward(W, c: dict, seqs: Sequence[torch.Tensor],
            route: Callable, quant=Exact()) -> List[torch.Tensor]:
    """seqs: token ids [n_i] (positions 0 .. n_i - 1) -> the final normed
    hidden state of every position of each, float32 [n_i, d].

    ``route(layer, logits [N, E]) -> (experts [N, k], gates [N, k],
    kept [N, k] bool)`` over the rows of all sequences in order."""
    Lw = W["layers"]
    eps, theta = c["norm_eps"], c["rope_theta"]
    H, Hkv, hd = c["num_heads"], c["num_kv_heads"], c["head_dim"]
    dev = W["final_norm"].device
    lens = [len(s) for s in seqs]
    tok = torch.cat([s.to(dev).long() for s in seqs])
    x = W["embed"]["table"][tok].float()
    for li in range(c["num_layers"]):
        h = rms_norm(x, Lw["ln1"][li], eps)
        q = linear(h, Lw["attn"]["wq"][li], quant).view(-1, H, hd)
        k = linear(h, Lw["attn"]["wk"][li], quant).view(-1, Hkv, hd)
        v = linear(h, Lw["attn"]["wv"][li], quant).view(-1, Hkv, hd)
        outs, a = [], 0
        for n in lens:
            pos = torch.arange(n, device=dev)
            outs.append(causal_attention(rope(q[a:a + n], pos, theta),
                                         rope(k[a:a + n], pos, theta),
                                         v[a:a + n]))
            a += n
        att = torch.cat(outs).reshape(-1, H * hd)
        x = x + linear(att, Lw["attn"]["wo"][li], quant)
        h = rms_norm(x, Lw["ln2"][li], eps)
        experts, gates, kept = route(li, router_logits(W, c, li, h))
        y = swiglu(h, Lw["dense"]["wi_gate"][li], Lw["dense"]["wi_up"][li],
                   Lw["dense"]["wo"][li], quant)
        moe = Lw["moe"]
        for e in torch.unique(experts[kept]).tolist():
            rows, rank = torch.nonzero((experts == e) & kept, as_tuple=True)
            out = swiglu(h[rows], moe["wi_gate"][li, e], moe["wi_up"][li, e],
                         moe["wo"][li, e], quant)
            y.index_add_(0, rows, out * gates[rows, rank][:, None])
        x = x + y
    x = rms_norm(x, W["final_norm"], eps)
    return list(torch.split(x, lens))


def logits(W, h: torch.Tensor, quant=Exact(), block: int = 512
           ) -> torch.Tensor:
    """[n, d] final hidden -> [n, V] float32 logits, in row blocks."""
    return torch.cat([linear(h[a:a + block], W["embed"]["unembed"], quant)
                      for a in range(0, h.shape[0], block)])


def top_k(logits_: torch.Tensor, k: int):
    """(experts [N, k], gates [N, k]): the k most probable experts by a
    stable descending sort (a tie to the lower id) and their
    probabilities renormalized to sum to 1."""
    probs = torch.softmax(logits_, dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    return order.indices[:, :k], order.values[:, :k]


def gates_of(logits_: torch.Tensor, experts: torch.Tensor) -> torch.Tensor:
    probs = torch.softmax(logits_, dim=-1).gather(1, experts)
    return probs / probs.sum(-1, keepdim=True).clamp(min=1e-9)
