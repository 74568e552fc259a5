"""The traced slice's wall time over the decode forwards its dispatches
ran (each a step of ``Model.decode_loop``, counted from the dispatch
records); the chunk forwards of the same ticks are inside the wall."""
DRIVER, UNIT, SOURCE = "serve", "ms", "host_clock"
LAYER = "model dispatch (models/model.py)"
MOVES = "tpot_p95_ms"


def read(ctx):
    n = sum(d["k"] for d in ctx["dispatches_traced"])
    return 1e3 * ctx["traced_s"] / n if n else None
