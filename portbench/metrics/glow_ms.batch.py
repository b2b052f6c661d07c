"""Device ms per batch of the work launched in the engine's encode and flow
decode (the ``glow`` ranges)."""


def read(ctx):
    if not ctx.n_batches:
        return None
    value = ctx.trace.device_s("glow")
    return 1e3 * value / ctx.n_batches if value > 0 else None
