"""The port's own spans and counters in the traced run
(``larynx_tpu_torch/runtime/trace.py``), and what the per-layer readers
compute from them.

:func:`install` wraps :func:`harness.trace.profiled`, the traced run's
profiled window, so that the port's tracing is turned on and reset before
the window opens, and its counters and spans are taken, and tracing turned
back off, after the window has closed: nothing of this falls inside
``window_s``.  Inside the window the port's spans land in the profiler's
trace as ``user_annotation`` ranges on the engine's thread (its
``kernel.*`` spans stay out of the profiler).  Each reader that needs the
window's spans or counters calls :func:`install` when it is loaded; the
untraced run never enters the window.  On a port without the registry,
:func:`set_tracing` and :func:`snapshot` return None, the window is
profiled as before, and those readers read nothing.
"""

import bisect
import collections
import contextlib

from portbench.counts import mrf, peaks, wn
from portbench.harness import trace

PROGRAM = ("engine.", "scheduler.", "server.", "frontend.")
LAUNCH = ("engine.encode", "engine.decode", "engine.vocode", "engine.vocode_group")

_window = {}  # the last profiled window's counter differences and spans, once it has ended


def _registry():
    try:
        from larynx_tpu_torch.runtime import trace as registry
    except ImportError:
        return None
    return registry


def set_tracing(on):
    """Turn the port's tracing on or off -> whether it was on before, or
    None when the port has no registry."""
    registry = _registry()
    if registry is None:
        return None
    was = registry.enabled()
    registry.enable(bool(on))
    return was


def snapshot():
    """The registry's counters, span aggregates and buffered spans, or None."""
    registry = _registry()
    return None if registry is None else registry.snapshot()


def window_counters():
    """Counter differences over the last profiled window, or None."""
    return _window.get("counters")


def window_spans():
    """The port's spans buffered in the last profiled window, or None."""
    return _window.get("spans")


_PROFILED = trace.profiled


@contextlib.contextmanager
def profiled(ranges):
    """:func:`harness.trace.profiled` with the port's tracing on, and reset,
    from before the window opens to after it closes."""
    _window.clear()
    was = set_tracing(True)
    if was is None:
        with _PROFILED(ranges) as out:
            yield out
        return
    registry = _registry()
    registry.reset()
    before = registry.counters()
    try:
        with _PROFILED(ranges) as out:
            yield out
    finally:
        after = registry.snapshot()
        registry.enable(was)
    _window["counters"] = {k: after["counters"].get(k, 0) - before.get(k, 0)
                           for k in set(before) | set(after["counters"])}
    _window["spans"] = after["buffer"]


def install():
    """Profile the traced run's window through :func:`profiled` (calling it
    again changes nothing)."""
    trace.profiled = profiled


# ----------------------------------------------------------------------
# reductions of a harness Trace (all times in the trace's microseconds)


def program_spans(tr):
    """{thread: [(start, end, name)]} of the port's spans in the trace (read
    from ``Trace``'s per-thread unions, which it has no public accessor for)."""
    out = collections.defaultdict(list)
    for (name, tid), (union, _starts) in tr._unions.items():
        if name.startswith(PROGRAM):
            out[tid].extend((s, e, name) for s, e in union)
    return out


def engine_thread(spans):
    """The thread whose ``engine.batch`` spans cover the most time, or None."""
    best, best_us = None, 0.0
    for tid, items in spans.items():
        us = sum(e - s for s, e, name in items if name == "engine.batch")
        if us > best_us:
            best, best_us = tid, us
    return best


def innermost(spans):
    """Nested (start, end, name) spans of one thread -> disjoint sorted
    (start, end, name) segments, each labelled with the innermost span open
    there; time outside every span has no segment."""
    out, stack, t = [], [], None

    def close_until(limit):
        nonlocal t
        while stack and stack[-1][1] <= limit:
            s, e, name = stack.pop()
            if t < e:
                out.append((t, e, name))
                t = e

    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        close_until(s)
        if stack:
            e = min(e, stack[-1][1])  # a child ends inside its parent
            if t < s:
                out.append((t, s, stack[-1][2]))
        stack.append((s, e, name))
        t = s
    close_until(float("inf"))
    return out


def busy_intervals(tr):
    """Sorted disjoint (start, end) stretches in which a kernel, copy or
    memset runs on the device."""
    out = []
    for s, e in sorted((d["ts"], d["ts"] + d["dur"]) for d in tr.device):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def idle_intervals(busy, lo, hi):
    """(start, end) stretches of [lo, hi] outside the ``busy`` intervals."""
    out, t = [], lo
    for s, e in busy:
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


def category(name):
    """``launch`` (the host issuing work), ``host`` (another engine step) or None."""
    if name in LAUNCH:
        return "launch"
    return "host" if name.startswith("engine.") else None


def idle_split(tr):
    """Device-idle seconds of the trace by the innermost port span open on the
    engine's thread -> {"launch": s, "host": s}, or None without its spans."""
    spans = program_spans(tr)
    tid = engine_thread(spans)
    busy = busy_intervals(tr)
    if tid is None or not busy:
        return None
    segments = innermost(spans[tid])
    starts = [s for s, _e, _n in segments]
    lo, hi = min(segments[0][0], busy[0][0]), max(segments[-1][1], busy[-1][1])
    out = {"launch": 0.0, "host": 0.0}
    for a, b in idle_intervals(busy, lo, hi):
        i = max(0, bisect.bisect_right(starts, a) - 1)
        while i < len(segments) and segments[i][0] < b:
            s, e, name = segments[i]
            overlap = min(b, e) - max(a, s)
            kind = category(name)
            if overlap > 0 and kind is not None:
                out[kind] += overlap / 1e6
            i += 1
    return out


# ----------------------------------------------------------------------
# the kernels' bounds from the port's kernel spans


def kernel_bound_s(span):
    """The roofline bound, in seconds, of one buffered ``kernel.mrf_section``
    or ``kernel.wn_layer`` span from the shapes it carries, or None for
    another span.  The WN layer's res/skip width and weight count follow
    from its widths: the dilated conv (3 taps) and the conditioning 1x1 into
    2ch gates with one summed bias, the res/skip 1x1 into 2ch channels (ch
    for the last layer, which writes the skip alone) with its bias."""
    a = span["attrs"]
    if span["name"] == "kernel.mrf_section":
        taps = mrf.section_taps(a["kernel_sizes"], a["dilations"], a["convs_per_unit"])
        return peaks.bound_s(
            mrf.section_flops(a["B"], a["T"], a["C"], taps),
            mrf.section_bytes(a["B"], a["T"], a["C"], a["kernel_sizes"], a["dilations"],
                              a["convs_per_unit"], a["itemsize"]), a["itemsize"])
    if span["name"] == "kernel.wn_layer":
        b, t, ch, cc = a["B"], a["T"], a["ch"], a["cc"]
        rs_out = ch if a["last"] else 2 * ch
        weights = 2 * ch * (3 * ch + cc + 1) + rs_out * (ch + 1)
        return peaks.bound_s(
            wn.layer_flops(b, t, ch, cc, rs_out),
            wn.layer_bytes(b, t, ch, cc, rs_out, a["first"], a["last"], weights, a["itemsize"]),
            a["itemsize"])
    return None
