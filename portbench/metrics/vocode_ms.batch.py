"""Device ms per batch of the work launched in the engine's vocode (the
``vocode`` ranges: the vocoder, int16 and the copies to the host)."""


def read(ctx):
    if not ctx.n_batches:
        return None
    value = ctx.trace.device_s("vocode")
    return 1e3 * value / ctx.n_batches if value > 0 else None
