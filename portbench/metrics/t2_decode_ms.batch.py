"""Device ms per batch of the work launched inside the port's
``engine.decode`` spans: the autoregressive decode and the postnet."""

from portbench.harness import program_trace

program_trace.install()  # the port's spans in the window


def read(ctx):
    if not ctx.n_batches:
        return None
    value = ctx.trace.device_s("engine.decode")
    return 1e3 * value / ctx.n_batches if value > 0 else None
