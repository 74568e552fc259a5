"""Share of the traced slice of a served window in which no operation
ran on the device (the union of the device operations' intervals)."""
DRIVER, UNIT, SOURCE = "serve", "%", "device_trace"
LAYER = "device"
MOVES = "output_tokens_per_s"


def read(ctx):
    s = ctx["summary"]
    return 100.0 * (1 - s.busy_s / s.window_s) if s.window_s > 0 else None
