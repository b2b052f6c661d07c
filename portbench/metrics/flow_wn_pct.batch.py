"""Share of GlowTTS's flow WaveNet layers that ran on the port's flow WN
kernel, from its counters over the traced window: 100 x the layers the
kernel ran (``engine.flow_wn_kernel_layers``) over every flow WaveNet layer
(``engine.flow_wn_layers``), graph replays included.  A port without those
counters reads nothing."""

from portbench.harness import program_trace

program_trace.install()


def read(ctx):
    c = program_trace.window_counters()
    if not c or not c.get("engine.flow_wn_layers"):
        return None
    return 100.0 * c.get("engine.flow_wn_kernel_layers", 0) / c["engine.flow_wn_layers"]
