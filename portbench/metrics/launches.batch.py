"""Kernels launched inside the port's ``engine.batch`` spans, per span."""

from portbench.harness import program_trace

program_trace.install()  # the port's spans in the window


def read(ctx):
    n = ctx.trace.count("engine.batch")
    if not n or ctx.trace.busy_s <= 0:
        return None
    return ctx.trace.kernels_in("engine.batch") / n
