"""Vocoded frames (each row group's rows x width) over the valid frames,
from the port's counters over the traced window."""

from portbench.harness import program_trace

program_trace.install()


def read(ctx):
    c = program_trace.window_counters()
    if not c or not c.get("engine.valid_frames"):
        return None
    return c.get("engine.vocode_frames", 0) / c["engine.valid_frames"]
