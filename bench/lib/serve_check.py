"""The check of a served run: the plain float32 reference run once over
a sample of the finished requests (each padded prompt with its served
tokens), and the gap by which each served token's logit lies below the
reference's best.

Under expert capacity a row's kept choices depend on the rows before it
in its dispatch (FIFO), which belong to other requests.  The reference
cannot replay every request of the run in its time, so for those other
rows it takes the program's routing ids (``Recorder.routes``) and counts,
by the frozen FIFO rule, how many choices of each expert came before the
row.  Everything else it works out itself from the weights it was
handed: attention over the request's own positions, its routing (where
the program's experts for a row are among the reference's top k within
``router_tol`` of logit, it takes the program's, so a rounding tie does
not flip a choice; the widest such margin is itself a compared number),
the experts, the dense residual and the LM head.  Positions a request
adopted from the prefix cache are computed with the kept choices of the
dispatch row that wrote them."""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from bench.lib.traffic import bucket
from bench.lib.work import capacity


def padded(prompt: np.ndarray) -> np.ndarray:
    """The engine's token stream for a prompt: left-padded with 0 to its
    bucket."""
    n = bucket(len(prompt))
    out = np.zeros(n, np.int64)
    out[n - len(prompt):] = prompt
    return out


def sources(rec, page_size: int) -> Dict[int, dict]:
    """{req_id: {"src": {position: (layer-0 route call, row, rows in the
    call)}, "first": first chunk's start}} from the dispatch records:
    each position's source is the dispatch row that wrote its K/V."""
    L = rec.layers
    writer: Dict[tuple, tuple] = {}
    out: Dict[int, dict] = {}
    for d in rec.dispatches:
        call, bt, slots = d["r0"], d["bt"], d["slots"]
        B = len(slots)
        if d["chunk"] is not None:
            C = d["chunk"].shape[1]
            for b in np.nonzero(d["nval"] > 0)[0]:
                info = out.setdefault(int(slots[b]), {"src": {},
                                                      "first": None})
                st, n = int(d["start"][b]), int(d["nval"][b])
                if info["first"] is None:
                    info["first"] = st
                    for p in range(st):
                        w = writer.get((int(bt[b, p // page_size]),
                                        p % page_size))
                        if w is not None:
                            info["src"][p] = w
                for t in range(n):
                    p = st + t
                    src = (call, int(b) * C + t, B * C)
                    info["src"][p] = src
                    writer[(int(bt[b, p // page_size]), p % page_size)] = src
            call += L
        if d["k"] and d["blk"] is not None:
            pos = d["pos"].astype(np.int64).copy()
            for s in range(d["k"]):
                for b in np.nonzero(d["blk"][:, s] >= 0)[0]:
                    p = int(pos[b])
                    src = (call, int(b), B)
                    out.setdefault(int(slots[b]), {"src": {}, "first": None}
                                   )["src"][p] = src
                    writer[(int(bt[b, p // page_size]), p % page_size)] = src
                    pos[b] += 1
                call += L
        if call != d["r1"]:
            raise RuntimeError(f"dispatch routed {d['r1'] - d['r0']} expert "
                               f"calls, {call - d['r0']} expected")
    return out


class Router:
    """The ``route`` callback of ``reference.moe_decoder.forward`` for the
    rows of the sampled sequences: each row's candidate experts adopted
    where within ``tol`` of the reference's top k, its kept choices by
    the FIFO count of the program's routing ids before it."""

    def __init__(self, ref, rec, srcs: List[tuple], cand: Optional[dict],
                 sizes: dict, tol: float, device):
        self.ref, self.rec, self.tol, self.dev = ref, rec, tol, device
        self.k, self.E = sizes["top_k"], sizes["num_experts"]
        self.srcs, self.cand = srcs, cand
        self.cap = torch.tensor([capacity(s[2], self.k,
                                          sizes["capacity_factor"], self.E)
                                 for s in srcs], device=device)
        self.margin = 0.0
        self._counts: Dict[int, torch.Tensor] = {}

    def _before(self, call: int) -> torch.Tensor:
        """[t + 1, E] int32: choices of each expert in rows < j."""
        got = self._counts.get(call)
        if got is None:
            ids = self.rec.routes[call].long()
            oh = torch.zeros((ids.shape[0], self.E), dtype=torch.int32,
                             device=ids.device)
            oh.scatter_add_(1, ids, torch.ones_like(ids, dtype=torch.int32))
            got = torch.cat([torch.zeros_like(oh[:1]), oh.cumsum(0)])
            self._counts[call] = got
        return got

    def kept(self, layer: int, experts: torch.Tensor) -> torch.Tensor:
        """[N, k] bool: each row's choice finds a free slot of its expert
        after the program's choices in the rows before it."""
        prior = torch.stack([self._before(s[0] + layer)[s[1]].to(self.dev)
                             for s in self.srcs])
        return prior.gather(1, experts) < self.cap[:, None]

    def program_ids(self, layer: int) -> torch.Tensor:
        return torch.stack([self.rec.routes[s[0] + layer][s[1]]
                            for s in self.srcs]).long().to(self.dev)

    def __call__(self, layer: int, logits: torch.Tensor):
        ref_e, _ = self.ref.top_k(logits, self.k)
        cand = (self.program_ids(layer) if self.cand is None
                else self.cand[layer])
        thr = logits.gather(1, ref_e).min(1).values
        low = logits.gather(1, cand).min(1).values
        margin = torch.clamp(thr - low, min=0.0)
        self.margin = max(self.margin, float(margin.max()))
        experts = torch.where((margin <= self.tol)[:, None], cand, ref_e)
        return experts, self.ref.gates_of(logits, experts), \
            self.kept(layer, experts)


class OwnRouter(Router):
    """The control's routing: its own top k, kept by the same FIFO count;
    ``chosen`` keeps the experts it chose, the control's candidates."""

    def __call__(self, layer, logits):
        experts, _ = self.ref.top_k(logits, self.k)
        self.chosen = {**getattr(self, "chosen", {}), layer: experts}
        return experts, self.ref.gates_of(logits, experts), \
            self.kept(layer, experts)


def prepare(rec, samples: List[dict], page_size: int):
    """Sequences, their rows' sources and output positions for the
    sampled requests (dicts with ``req_id``, ``prompt``, ``tokens``);
    requests with a position of unknown source are left out."""
    srcmap = sources(rec, page_size)
    seqs, srcs, outs, kept = [], [], [], []
    for s in samples:
        pp = padded(s["prompt"])
        toks = np.asarray(s["tokens"], np.int64)
        seq = np.concatenate([pp, toks[:-1]])
        info = srcmap.get(s["req_id"])
        if info is None or any(p not in info["src"]
                               for p in range(len(seq))):
            continue
        seqs.append(torch.from_numpy(seq))
        srcs += [info["src"][p] for p in range(len(seq))]
        outs.append((len(pp) - 1, toks))
        kept.append(s)
    return seqs, srcs, outs, kept


def gaps(ref, W, hidden: List[torch.Tensor], outs) -> torch.Tensor:
    """Each served token's gap below the reference's best logit."""
    out = []
    for h, (first, toks) in zip(hidden, outs):
        lg = ref.logits(W, h[first:first + len(toks)])
        t = torch.as_tensor(toks, device=lg.device).long()
        out.append(lg.max(1).values - lg.gather(1, t[:, None])[:, 0])
    return torch.cat(out)


def check(ref, W, sizes, rec, samples, tol: float, page_size: int,
          quant=None) -> dict:
    """Readings for the program (``quant`` None) or for the control (the
    reference under ``quant`` in the program's place): {"logit_gap_max",
    "router_gap_max", "tokens", "requests"}."""
    from bench.reference.common import strict_f32
    strict_f32()
    dev = W["final_norm"].device
    seqs, srcs, outs, used = prepare(rec, samples, page_size)
    if not seqs:
        return {"requests": 0, "tokens": 0}
    with torch.no_grad():
        cand = None
        if quant is not None:
            own = OwnRouter(ref, rec, srcs, None, sizes, tol, dev)
            hid = ref.forward(W, sizes, seqs, own, quant)
            outs = [(first, ref.logits(W, h[first:first + len(t)], quant)
                     .argmax(1).cpu().numpy())
                    for h, (first, t) in zip(hid, outs)]
            cand = own.chosen
        router = Router(ref, rec, srcs, cand, sizes, tol, dev)
        hid = ref.forward(W, sizes, seqs, router)
        g = gaps(ref, W, hid, outs)
    return {"logit_gap_max": float(g.max()), "router_gap_max": router.margin,
            "tokens": int(g.numel()), "requests": len(used)}
