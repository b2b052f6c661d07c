"""The share of the traced window in which the device idles while the
innermost port span open on the engine's thread launches work
(``engine.encode``, ``engine.decode``, ``engine.vocode`` with its
``engine.vocode_group`` spans; a kernel call's time falls to the span
around it): the host issuing work more slowly than the device drains it."""

from portbench.harness import program_trace

program_trace.install()


def read(ctx):
    split = program_trace.idle_split(ctx.trace)
    if split is None or ctx.window_s <= 0:
        return None
    return 100.0 * split["launch"] / ctx.window_s
