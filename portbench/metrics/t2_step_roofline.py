"""The autoregressive decode's share of its roofline: the sum over the
window's decoder steps of the step's bound (``counts/tacotron2.py``, from
the rows, text bucket and steps that each ``engine.decode`` span of the
family "tacotron2" carries) over the device time of the decoder steps'
kernels: those launched inside an ``engine.decode`` span before the end of
its last ``engine.ar_stop_check`` (the postnet follows that read).  It reads
the same work whatever implements the step."""

import bisect

from portbench.counts import tacotron2 as counts
from portbench.harness import program_trace

program_trace.install()  # the port's spans in the window


def _loops(tr):
    """{thread: sorted [(start, end)]} of the decoder loops in the trace: a
    decode span from its start to the end of its last stop read."""
    out = {}
    for tid, items in program_trace.program_spans(tr).items():
        checks = sorted((s, e) for s, e, name in items if name == "engine.ar_stop_check")
        loops = []
        for s, e in sorted((s, e) for s, e, name in items if name == "engine.decode"):
            ends = [ce for cs, ce in checks if s <= cs and ce <= e]
            if ends:
                loops.append((s, max(ends)))
        if loops:
            out[tid] = loops
    return out


def steps_device_s(tr):
    """Device seconds of the kernels launched inside the decoder loops."""
    loops = _loops(tr)
    starts = {tid: [s for s, _e in v] for tid, v in loops.items()}
    total = 0.0
    for event, launch in zip(tr.device, tr.launch):
        if event.get("cat") != "kernel" or launch is None or launch[0] not in loops:
            continue
        i = bisect.bisect_right(starts[launch[0]], launch[1]) - 1
        if i >= 0 and launch[1] <= loops[launch[0]][i][1]:
            total += event["dur"]
    return total / 1e6


def read(ctx):
    spans = [s for s in program_trace.window_spans() or ()
             if s["name"] == "engine.decode" and s["attrs"].get("family") == "tacotron2"
             and "steps" in s["attrs"]]
    device = steps_device_s(ctx.trace) if spans else 0.0
    if device <= 0:
        return None
    cfg = ctx.config["acoustic"]
    bound = sum(s["attrs"]["steps"] * counts.step_bound_s(cfg, s["attrs"]["rows"],
                                                          s["attrs"]["text_bucket"])
                for s in spans)
    return 100.0 * bound / device
