"""Spans and counters of the port, in one registry.

Tracing is off by default; ``LARYNX_TPU_TRACE=1`` (read at import, like the
engine's other ``LARYNX_TPU_*`` flags) or :func:`enable` turns it on.

``span(name, id=None, profile=True, **attrs)`` is a context manager around
one step of work.  Off, it returns one shared no-op object: the cost is a call and one
flag test.  On, it records the name, start and end
(``time.perf_counter_ns``), the thread, the parent (the innermost span open
on the same thread), the ``id`` of the request or engine call it serves
(inherited from the parent when not given) and the attributes, keeps the
span in a bounded buffer of the newest spans, and adds it to its name's
aggregates: count, total, self time (the duration less the time its child
spans cover), and p50 / p95 / max from a fixed log-bucket histogram.  While
a ``torch.profiler`` is active, each span is also a
``torch.profiler.record_function`` range, so it lands in the device trace
as a ``user_annotation`` on the thread that opened it, on the profiler's
clock, joined to the device work it launched by correlation id.
``profile=False`` keeps a span out of the profiler: a kernel call's span,
whose profiler range would cost about as much host time as the launches it
wraps, while the engine span around it already labels that work.

:func:`record` adds a finished span whose start was taken earlier (a queue
wait, a request served across ``await``): it has no parent and never
reaches the profiler.

``count(name, n=1)`` adds to a named integer counter; counters are always
on.  Inside :func:`tally` the counts a thread makes are collected in the
tally instead (a CUDA graph's capture, whose work runs at each replay: the
replay adds them).  :func:`snapshot` returns the counters, the span
aggregates and the buffered spans; :func:`stats` the counters and, while
tracing is on, the aggregates (``/api/stats``'s ``trace`` object);
:func:`reset` clears spans and aggregates.

The module's functions are those of one :class:`Registry`, ``REGISTRY``; a
test may build a registry of its own.
"""

import collections
import contextlib
import itertools
import os
import threading
import time
import typing

import torch.autograd.profiler as _profiler

BUFFER_SPANS = 1 << 14  # the newest spans kept
# the duration histogram: each doubling of the duration in ns split into
# HIST_PER_OCTAVE equal buckets (p50 / p95 within 1 / (2 * 4) of the value)
HIST_PER_OCTAVE = 4
HIST_BUCKETS = 64 * HIST_PER_OCTAVE


def _env_on() -> bool:
    return os.environ.get("LARYNX_TPU_TRACE", "0").lower() not in ("0", "false", "no")


class _Noop:
    """The span of a registry that is off: enters, exits and sets nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def set(self, **attrs):
        return None


NOOP = _Noop()


def _bucket(ns: int) -> int:
    """ns in [2^e (1 + j / 4), 2^e (1 + (j + 1) / 4)) -> 4 e + j."""
    e = ns.bit_length() - 1
    if e < 2:
        return max(ns, 0)
    return HIST_PER_OCTAVE * e + ((ns >> (e - 2)) & 3)


def _bucket_mid_ms(k: int) -> float:
    """A bucket's middle, in ms."""
    e, j = divmod(k, HIST_PER_OCTAVE)
    return 2.0 ** e * (1 + (j + 0.5) / HIST_PER_OCTAVE) / 1e6


class _Aggregate:
    __slots__ = ("count", "total_ns", "self_ns", "max_ns", "hist")

    def __init__(self):
        self.count = self.total_ns = self.self_ns = self.max_ns = 0
        self.hist = [0] * HIST_BUCKETS

    def add(self, dur_ns: int, self_ns: int) -> None:
        self.count += 1
        self.total_ns += dur_ns
        self.self_ns += self_ns
        self.max_ns = max(self.max_ns, dur_ns)
        self.hist[_bucket(dur_ns)] += 1

    def quantile_ms(self, q: float) -> float:
        """The q-quantile's bucket middle, at most the largest duration."""
        rank, seen = q * self.count, 0
        for k, n in enumerate(self.hist):
            seen += n
            if n and seen >= rank:
                return min(_bucket_mid_ms(k), self.max_ns / 1e6)
        return self.max_ns / 1e6

    def summary(self) -> typing.Dict[str, float]:
        return {"count": self.count, "total_ms": self.total_ns / 1e6,
                "self_ms": self.self_ns / 1e6, "p50_ms": self.quantile_ms(0.5),
                "p95_ms": self.quantile_ms(0.95), "max_ms": self.max_ns / 1e6}


class Span:
    """One span while tracing is on; :meth:`set` adds attributes.  A
    finished span is buffered as a plain tuple (:data:`FIELDS`)."""

    __slots__ = ("registry", "name", "id", "attrs", "profile", "seq", "tid", "parent", "start",
                 "end", "child_ns", "_stack", "_rf")

    def __init__(self, registry, name, id, attrs, profile=True):
        self.registry, self.name, self.id, self.attrs = registry, name, id, attrs
        self.profile = profile
        self.seq = next(registry._seq)
        self.parent = None
        self.child_ns = 0
        self._rf = None

    def set(self, **attrs):
        self.attrs.update(attrs)

    def __enter__(self):
        stack, self.tid = self.registry._thread()
        self._stack = stack
        if stack:
            self.parent = stack[-1]
            if self.id is None:
                self.id = self.parent.id
        stack.append(self)
        if self.profile and _profiler._is_profiler_enabled:
            self._rf = _profiler.record_function(self.name)
            self._rf.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        stack = self._stack
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        dur = self.end - self.start
        parent = self.parent
        if parent is not None:
            parent.child_ns += dur
        self.registry._finish(self, None if parent is None else parent.seq, dur,
                              dur - self.child_ns)
        return None


FIELDS = ("seq", "name", "id", "tid", "parent", "start_ns", "end_ns", "attrs")


class Registry:
    """Spans, their aggregates and counters; off unless ``on``."""

    def __init__(self, on: bool = False, buffer_spans: int = BUFFER_SPANS):
        self.on = bool(on)
        self._local = threading.local()
        self._lock = threading.Lock()
        self._seq = itertools.count()
        self._spans = collections.deque(maxlen=buffer_spans)
        self._aggregates: typing.Dict[str, _Aggregate] = {}
        self._counters: typing.Dict[str, int] = {}

    def enable(self, on: bool = True) -> None:
        self.on = bool(on)

    def enabled(self) -> bool:
        return self.on

    def _thread(self) -> typing.Tuple[list, int]:
        """This thread's (stack of open spans, native id)."""
        state = getattr(self._local, "state", None)
        if state is None:
            state = self._local.state = ([], threading.get_native_id())
        return state

    def span(self, name: str, id=None, profile: bool = True, **attrs):
        if not self.on:
            return NOOP
        return Span(self, name, id, attrs, profile)

    def record(self, name: str, start_ns: int, end_ns: typing.Optional[int] = None, id=None,
               **attrs) -> None:
        """A finished span from ``start_ns`` (``time.perf_counter_ns``) to
        ``end_ns`` (default now), with no parent."""
        if not self.on:
            return
        s = Span(self, name, id, attrs, profile=False)
        s.tid = self._thread()[1]
        s.start = start_ns
        s.end = time.perf_counter_ns() if end_ns is None else end_ns
        dur = s.end - s.start
        self._finish(s, None, dur, dur)

    def _finish(self, s: Span, parent_seq, dur: int, self_ns: int) -> None:
        row = (s.seq, s.name, s.id, s.tid, parent_seq, s.start, s.end, s.attrs)
        with self._lock:
            self._spans.append(row)
            agg = self._aggregates.get(s.name)
            if agg is None:
                agg = self._aggregates[s.name] = _Aggregate()
            agg.add(dur, self_ns)

    def count(self, name: str, n: int = 1) -> None:
        tallies = getattr(self._local, "tallies", None)
        if tallies:
            tallies[-1][name] = tallies[-1].get(name, 0) + int(n)
            return
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + int(n)

    @contextlib.contextmanager
    def tally(self):
        """Collect the counts this thread makes inside the block in the
        yielded dict, instead of adding them to the counters."""
        tallies = getattr(self._local, "tallies", None)
        if tallies is None:
            tallies = self._local.tallies = []
        counts: typing.Dict[str, int] = {}
        tallies.append(counts)
        try:
            yield counts
        finally:
            tallies.pop()

    def counters(self) -> typing.Dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def aggregates(self) -> typing.Dict[str, typing.Dict[str, float]]:
        with self._lock:
            return {name: agg.summary() for name, agg in sorted(self._aggregates.items())}

    def spans(self) -> typing.List[dict]:
        """The buffered spans in the order they ended, each a dict of
        :data:`FIELDS` (``parent`` is the parent's ``seq``)."""
        with self._lock:
            rows = list(self._spans)
        return [dict(zip(FIELDS, row[:-1]), attrs=dict(row[-1])) for row in rows]

    def snapshot(self) -> dict:
        return {"counters": self.counters(), "spans": self.aggregates(), "buffer": self.spans()}

    def stats(self) -> dict:
        """The counters, and the span aggregates while tracing is on."""
        out = {"counters": self.counters()}
        if self.on:
            out["spans"] = self.aggregates()
        return out

    def reset(self) -> None:
        """Clear the buffered spans and the aggregates (not the counters)."""
        with self._lock:
            self._spans.clear()
            self._aggregates.clear()


REGISTRY = Registry(on=_env_on())

enable = REGISTRY.enable
enabled = REGISTRY.enabled
span = REGISTRY.span
record = REGISTRY.record
count = REGISTRY.count
tally = REGISTRY.tally
counters = REGISTRY.counters
snapshot = REGISTRY.snapshot
stats = REGISTRY.stats
reset = REGISTRY.reset
