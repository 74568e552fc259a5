"""The paged-attention kernel's share of its roofline: each call of the
traced slice's dispatches (the chunk: T = chunk rows at ``start``, keys
to ``start + n_valid``; each decode step: T = 1 at the row's position,
keys to it plus its write) at ``lib/work.paged_work``, once a layer,
over the device time of the kernels named ``paged_``."""
import numpy as np

from bench.lib import peaks, work

DRIVER, UNIT, SOURCE = "serve", "%", "device_trace"
LAYER = "kernels (kernels/csrc)"
MOVES = "output_tokens_per_s"


def calls(d):
    """(T, lens, kv_lens) of each paged call one layer of a dispatch
    makes."""
    out = []
    if d["chunk"] is not None:
        C = d["chunk"].shape[1]
        start = d["start"].astype(np.int64)
        out.append((C, start + C, start + d["nval"]))
    if d["k"] and d["blk"] is not None:
        pos = d["pos"].astype(np.int64).copy()
        for s in range(d["k"]):
            alive = (d["blk"][:, s] >= 0).astype(np.int64)
            out.append((1, pos + 1, pos + alive))
            pos = pos + alive
    return out


def read(ctx):
    dev_s = ctx["summary"].op_seconds("paged_")
    if dev_s <= 0 or not ctx["dispatches_traced"]:
        return None
    z = ctx["sizes"]
    need = 0.0
    for d in ctx["dispatches_traced"]:
        B, P = d["bt"].shape
        for T, lens, kv in calls(d):
            nbytes, flops = work.paged_work(
                B, T, z["num_heads"], z["head_dim"], z["num_kv_heads"],
                B * P, lens, kv)
            need += z["num_layers"] * peaks.roofline_s(nbytes, flops)
    return 100.0 * need / dev_s
