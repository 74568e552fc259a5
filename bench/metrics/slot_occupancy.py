"""Share of decode-slot steps that did useful work over the window: the
engine's ``slot_busy_steps`` over ``decode_steps`` x ``max_batch``."""
DRIVER, UNIT, SOURCE = "serve", "%", "program_counter"
LAYER = "slot batcher (serve/engine.py)"
MOVES = "output_tokens_per_s"


def read(ctx):
    steps = ctx["stats1"]["decode_steps"] - ctx["stats0"]["decode_steps"]
    busy = (ctx["stats1"]["slot_busy_steps"]
            - ctx["stats0"]["slot_busy_steps"])
    return 100.0 * busy / (steps * ctx["max_batch"]) if steps else None
