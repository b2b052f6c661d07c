"""The traced run's instruments, all in the benchmark's own files: ranges
around the engine's methods and the model's op names, and the reduction of
``torch.profiler``'s trace to device time per range, device busy time,
the longest device operations and the longest idle gaps.

A device operation belongs to every range that was open, on the host
thread that launched it, when it was launched (matched through the
profiler's correlation ids): time is attributed by who launched the work,
never by a kernel's name.
"""

import bisect
import collections
import contextlib
import json
import os
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
NAME_CHARS = 100  # a device operation's name in the breakdown, cut to its head


class Ranges:
    """Wraps the engine's stages and the kernels' entry points in
    ``record_function`` ranges while open, and records the arguments of
    every ``mrf_section`` and ``fused_wn_layer_state`` call."""

    # range name -> the engine methods it wraps
    ENGINE = {
        "glow": ("encode_launch", "_encode_one", "decode_launch", "decode_launch_predicted",
                 "encode_decode_launch_predicted"),
        "vocode": ("vocode_launch", "_vocode"),
    }

    def __init__(self):
        self.mrf_calls = []  # (C, B, T, dtype itemsize, stage)
        self.wn_calls = []  # (B, T, layer, first, last)
        self.recording = False
        self._undo = []

    def _wrap(self, owner, attr, name, record=None):
        import torch

        inner = getattr(owner, attr)

        def wrapped(*args, **kwargs):
            if record is not None and self.recording:
                record(*args, **kwargs)
            with torch.profiler.record_function(name):
                return inner(*args, **kwargs)

        setattr(owner, attr, wrapped)
        self._undo.append((owner, attr, inner))

    def __enter__(self):
        from larynx_tpu_torch.models.hifi_gan import model as hifi_model
        from larynx_tpu_torch.models.waveglow import model as wg_model
        from larynx_tpu_torch.runtime.engine import SynthesisEngine

        for name, methods in self.ENGINE.items():
            for attr in methods:
                self._wrap(SynthesisEngine, attr, name)

        def mrf(x, stage):
            self.mrf_calls.append((x.shape[2], x.shape[0], x.shape[1], x.element_size(), stage))

        def wn(h, cond, skip, layer, dilation, first=False, last=False):
            self.wn_calls.append((h.shape[0], h.shape[1], layer, first, last))

        self._wrap(hifi_model, "mrf_section", "mrf_section", mrf)
        self._wrap(wg_model, "fused_wn_layer_state", "fused_wn_layer_state", wn)
        return self

    def __exit__(self, *exc):
        for owner, attr, inner in reversed(self._undo):
            setattr(owner, attr, inner)
        self._undo.clear()


@contextlib.contextmanager
def profiled(ranges):
    """Profile the block with the profiler on the CPU and the card; yields a
    dict that holds, after the block, ``trace`` (a :class:`Trace`)."""
    from torch.profiler import ProfilerActivity, profile
    import torch

    out = {}
    torch.cuda.synchronize()
    ranges.mrf_calls.clear()
    ranges.wn_calls.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ranges.recording = True
        start = time.perf_counter()
        yield out
        torch.cuda.synchronize()
        out["window_s"] = time.perf_counter() - start
        ranges.recording = False
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    out["trace"] = Trace(events)


def _union(intervals):
    """Sorted disjoint union of (start, end) pairs."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _inside(union, starts, t):
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= union[i][1]


class Trace:
    """A chrome trace reduced to what the metric readers ask for (all times
    in seconds)."""

    def __init__(self, events):
        xs = [e for e in events if e.get("ph") == "X"]
        self.device = [e for e in xs if e.get("cat") in DEVICE_CATS]
        runtime = {}
        for e in xs:
            if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {}):
                runtime[e["args"]["correlation"]] = (e["tid"], e["ts"])
        self.launch = [runtime.get(e.get("args", {}).get("correlation")) for e in self.device]
        spans = collections.defaultdict(list)
        self.range_counts = collections.Counter()
        self.annotations = []
        for e in xs:
            if e.get("cat") == "user_annotation":
                spans[(e["name"], e["tid"])].append((e["ts"], e["ts"] + e["dur"]))
                self.range_counts[e["name"]] += 1
                self.annotations.append((e["ts"], e["ts"] + e["dur"], e["name"]))
        self._unions = {}
        for key, iv in spans.items():
            u = _union(iv)
            self._unions[key] = (u, [s for s, _ in u])
        busy = _union((e["ts"], e["ts"] + e["dur"]) for e in self.device)
        self.busy_s = sum(e - s for s, e in busy) / 1e6
        self._busy = busy

    def _in_range(self, name, launch):
        if launch is None:
            return False
        entry = self._unions.get((name, launch[0]))
        return entry is not None and _inside(entry[0], entry[1], launch[1])

    def device_s(self, name):
        """Device seconds of the operations launched inside range ``name``."""
        return sum(e["dur"] for e, l in zip(self.device, self.launch)
                   if self._in_range(name, l)) / 1e6

    def kernels_in(self, name):
        """The number of kernels launched inside range ``name``."""
        return sum(1 for e, l in zip(self.device, self.launch)
                   if e.get("cat") == "kernel" and self._in_range(name, l))

    def count(self, name):
        return self.range_counts[name]

    def top_ops(self, n=10):
        totals = collections.Counter()
        for e in self.device:
            totals[e["name"][:NAME_CHARS]] += e["dur"] / 1e6
        return [[k, v] for k, v in totals.most_common(n)]

    def idle_gaps(self, n=10):
        """The n longest gaps between device operations, each labelled by the
        innermost harness range open on the host at the gap's start."""
        gaps = [(b[0] - a[1], a[1]) for a, b in zip(self._busy, self._busy[1:]) if b[0] > a[1]]
        gaps.sort(reverse=True)
        out = []
        for length, at in gaps[:n]:
            label, best = "outside any range", None
            for s, e, name in self.annotations:
                if s <= at <= e and (best is None or e - s < best):
                    label, best = name, e - s
            out.append([label, length / 1e6])
        return out
