"""Profiling: the program's tracer (named spans and counters on the host
clock) and device traces over torch.profiler.

The tracer is one module-level object, `TRACER`, with the module's `span`
and `count` bound to it. It records while it is switched on (`start()` to
`stop()`; `device_trace` switches it on for its block) and while any other
torch.profiler records, so that a profile opened by code that does not
know the tracer (a benchmark's traced window) holds the program's spans
too. Otherwise `span(name)` returns a shared no-op context and
`count(name, n)` returns at once: one test of two flags, no clock read, no
profiler range and no allocation. What it records stays in memory until
`stop()` or `take()` hands it over, at most MAX_RECORDS spans and as many
counts (more are dropped, and counted as dropped).

A span records its name, its start and end as `time.perf_counter_ns()`,
its parent (the innermost span open on the same thread), its thread and an
`id` that a root span is given and its children inherit: the step of a
training iteration, the call of a deploy, the round of the stream batcher.
While a profiler records, each span is also a `torch.profiler` range named
`sag.<name>` on the profiler's host timeline, which the profiler aligns
with the card's; a span never synchronises with the card.

The reference only had a disabled Chrome-trace block (dnn.py:525-542).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
import types

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import record_function

RANGE_PREFIX = "sag."
MAX_RECORDS = 1 << 17     # spans, and counts, kept between handovers


def _profiler_flag(module):
    """`module` where it holds torch's `_is_profiler_enabled` flag (set
    while any torch.profiler records), else a holder of False: a torch
    without the flag leaves the tracer to its own switch."""
    if hasattr(module, "_is_profiler_enabled"):
        return module
    return types.SimpleNamespace(_is_profiler_enabled=False)


_PROFILER = _profiler_flag(_autograd_profiler)


class _NoSpan:
    """The shared context a span is while the tracer is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("tracer", "name", "id", "parent", "thread", "start_ns", "end_ns", "range",
                 "generation")

    def __init__(self, tracer: "Tracer", name: str, id):
        self.tracer, self.name, self.id = tracer, name, id
        self.range = None

    def __enter__(self):
        tracer = self.tracer
        stack = tracer._stack()
        self.parent = stack[-1] if stack else None
        if self.id is None and self.parent is not None:
            self.id = self.parent.id
        self.thread = threading.get_ident()
        self.generation = tracer._generation
        stack.append(self)
        if _PROFILER._is_profiler_enabled:
            self.range = record_function(RANGE_PREFIX + self.name)
            self.range.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(None, None, None)
            self.range = None
        self.tracer._stack().pop()
        self.tracer._close(self)
        return False


@dataclasses.dataclass(frozen=True)
class SpanRecord:
    name: str
    start_ns: int
    end_ns: int
    parent: int | None      # index in Trace.spans of the enclosing span, None for a root
    thread: int             # threading.get_ident() of the thread it ran on
    id: object              # the root's id, inherited by its children
    self_ns: int            # the duration less the part its children cover

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns


@dataclasses.dataclass
class Trace:
    """What the tracer hands over: spans in the order they ended (a child
    before its parent), and counter totals."""

    spans: list
    counters: dict

    def of(self, name: str) -> list:
        return [s for s in self.spans if s.name == name]

    def summary(self) -> dict:
        """{span name: {"total_s", "count", "mean_ms", "self_s"}}."""
        out: dict = {}
        for s in self.spans:
            row = out.setdefault(s.name, {"total_s": 0.0, "count": 0, "self_s": 0.0})
            row["total_s"] += s.duration_ns * 1e-9
            row["self_s"] += s.self_ns * 1e-9
            row["count"] += 1
        for row in out.values():
            row["mean_ms"] = 1000.0 * row["total_s"] / row["count"]
        return out


class Tracer:
    """Spans and counters of the program (module docstring)."""

    def __init__(self):
        self.on = False
        self._local = threading.local()
        self._lock = threading.Lock()
        self._generation = 0
        self._closed: list = []
        self._counts: list = []     # (time ns, name, n)
        self._dropped = {"spans": 0, "counts": 0}

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _close(self, s: _Span):
        if s.generation != self._generation:    # opened before the last handover
            return
        if len(self._closed) < MAX_RECORDS:
            self._closed.append(s)
        else:
            self._dropped["spans"] += 1

    def span(self, name: str, id=None):
        """A context that records the span `name`; `id` marks a root (a
        child inherits its parent's id unless given one)."""
        if not (self.on or _PROFILER._is_profiler_enabled):
            return _NO_SPAN
        return _Span(self, name, id)

    def count(self, name: str, n: int = 1):
        """Add `n` to the counter `name`."""
        if not (self.on or _PROFILER._is_profiler_enabled):
            return
        with self._lock:
            if len(self._counts) < MAX_RECORDS:
                self._counts.append((time.perf_counter_ns(), name, int(n)))
            else:
                self._dropped["counts"] += 1

    def current_id(self):
        """The id of the innermost span open on this thread (None if none):
        for a span that another thread records on this one's behalf."""
        stack = getattr(self._local, "stack", None)
        return stack[-1].id if stack else None

    def start(self):
        """Switch the tracer on with nothing recorded."""
        self.take()
        self.on = True

    def stop(self) -> Trace:
        """Switch the tracer off and hand over what it recorded."""
        self.on = False
        return self.take()

    def take(self) -> Trace:
        """Hand over what was recorded and keep nothing; spans open now are
        not recorded when they end."""
        with self._lock:
            trace = self.snapshot()
            self._generation += 1
            self._closed, self._counts = [], []
            self._dropped = {"spans": 0, "counts": 0}
        return trace

    def snapshot(self, start_ns: int | None = None, end_ns: int | None = None) -> Trace:
        """What was recorded, kept: spans that started, and counts made, in
        [start_ns, end_ns) when bounds are given."""
        lo = start_ns if start_ns is not None else -1
        hi = end_ns if end_ns is not None else float("inf")
        closed = [s for s in self._closed if lo <= s.start_ns < hi]
        index = {id(s): i for i, s in enumerate(closed)}
        covered = [0] * len(closed)
        for s in closed:
            if s.parent is not None and id(s.parent) in index:
                covered[index[id(s.parent)]] += s.end_ns - s.start_ns
        spans = [SpanRecord(s.name, s.start_ns, s.end_ns,
                            index.get(id(s.parent)) if s.parent is not None else None,
                            s.thread, s.id, s.end_ns - s.start_ns - covered[i])
                 for i, s in enumerate(closed)]
        counters: dict = {}
        for t, name, n in list(self._counts):
            if lo <= t < hi:
                counters[name] = counters.get(name, 0) + n
        for what, n in self._dropped.items():
            if n:
                counters[f"tracer.dropped_{what}"] = n
        return Trace(spans, counters)


TRACER = Tracer()
span = TRACER.span
count = TRACER.count


@contextlib.contextmanager
def device_trace(logdir: str, device="cuda"):
    """Trace the block with torch.profiler: host (CPU) activity with the
    tracer's `sag.*` ranges, and the card's kernels and copies when `device`
    is a CUDA device. The tracer is switched on for the block, with nothing
    recorded before it, and off after; the block gets a holder whose
    `trace` is, on exit, what the tracer recorded in it (a Trace). The trace
    file is written under `logdir` as `<host>_<pid>.<time>.pt.trace.json`,
    which TensorBoard's torch-profiler plugin and Chrome's trace viewer
    (chrome://tracing, Perfetto) open. Asked for a CUDA device where there
    is no card, it raises."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device_trace: a CUDA trace was asked for, and there is no card")
        activities.append(ProfilerActivity.CUDA)
    held = types.SimpleNamespace(trace=None)
    TRACER.start()
    try:
        with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
            yield held
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
    finally:
        held.trace = TRACER.stop()
