"""Autoregressive decoder frames launched (batch-bucket rows x steps run)
over the valid frames, from the port's counters over the traced window."""

from portbench.harness import program_trace

program_trace.install()


def read(ctx):
    c = program_trace.window_counters()
    if not c or not c.get("engine.valid_frames") or not c.get("engine.ar_frames"):
        return None
    return c["engine.ar_frames"] / c["engine.valid_frames"]
