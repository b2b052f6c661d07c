"""The share of the traced window in which the device idles while the
innermost port span open on the engine's thread is another engine step
(``engine.pad``, ``engine.lengths_wait``, ``engine.collect``,
``engine.crop``, or ``engine.batch`` itself).  ``idle_pct.batch`` less this
and ``idle_launch_pct.batch`` is the idle time outside the engine's calls."""

from portbench.harness import program_trace

program_trace.install()


def read(ctx):
    split = program_trace.idle_split(ctx.trace)
    if split is None or ctx.window_s <= 0:
        return None
    return 100.0 * split["host"] / ctx.window_s
