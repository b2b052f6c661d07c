"""GlowTTS's flow decode's share of its roofline: the bound of the model
FLOPs of the window's valid frames (``kinds/glow_tts.py::glow_decode_flops``,
the padding not counted) at the float32 rate, 3 TF32 operations a FLOP
(``counts/peaks.py``), over the device time of the work launched inside the
port's ``engine.decode`` spans of the window.  It reads the same work
whatever implements the decode."""

from portbench import kinds
from portbench.counts import peaks
from portbench.harness import program_trace

program_trace.install()  # the port's spans in the window

F32_ITEMSIZE = 4


def read(ctx):
    acoustic = ctx.config["acoustic"]
    kind = kinds.load(acoustic["kind"])
    if not ctx.requests or not hasattr(kind, "glow_decode_flops"):
        return None
    device_s = ctx.trace.device_s("engine.decode")
    if device_s <= 0:
        return None
    flops = sum(kind.glow_decode_flops(acoustic, frames) for _n_ids, frames in ctx.requests)
    return 100.0 * peaks.bound_s(flops, 0, F32_ITEMSIZE) / device_s
