"""The share of the traced window in which no kernel, copy or memset ran on
the device (the union of the device's intervals in the trace)."""


def read(ctx):
    if ctx.window_s <= 0 or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - ctx.trace.busy_s / ctx.window_s)
