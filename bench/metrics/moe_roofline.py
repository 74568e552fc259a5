"""The expert layer's share of its roofline: over the ``moe.block``
calls of the traced slice, the least time each needs (its router, the
weights of the experts that receive a kept choice under the FIFO
capacity rule, its activations in and out; the router's and the kept
choices' products: ``lib/work.moe_work``) over the device time under
the ``moe.block`` range."""
from bench.lib import peaks, work

DRIVER, UNIT, SOURCE = "serve", "%", "device_trace"
LAYER = "experts (models/moe.py)"
MOVES = "output_tokens_per_s"


def read(ctx):
    dev_s = ctx["summary"].ranges.get("moe.block", 0.0)
    if not ctx["routes_traced"] or dev_s <= 0:
        return None
    z = ctx["sizes"]
    E, k = z["num_experts"], z["top_k"]
    need = 0.0
    for eids in ctx["routes_traced"]:
        C = work.capacity(eids.shape[0], k, z["capacity_factor"], E)
        nbytes, flops = work.moe_work(eids.astype("int64"), z["d_model"],
                                      z["d_ff_expert"], E, C)
        need += peaks.roofline_s(nbytes, flops)
    return 100.0 * need / dev_s
