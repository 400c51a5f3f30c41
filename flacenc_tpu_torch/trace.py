"""Spans and point events of a traced encode (``FLACENC_TIMELINE=1``).

With the variable set, each `models.batch_encoder.BatchRunner` makes a
`Tracer`, and every thread that works for it (the caller, the dispatch lane,
the io workers) records into it; unset, the runner holds None and each site
costs one ``is None`` test (`span(None, ...)` returns `NULL`).

A span is its name, the tracer's call id, the batch's submit sequence number
(`seq`, or None), the thread's name, start and end from
`time.perf_counter_ns`, and its parent: the span open on the same thread
when it began. A span opened with ``cpu=True`` also keeps the thread's CPU
nanoseconds over it (`time.thread_time_ns`); the others keep None. Spans of
one batch share (call, seq). A name with a dot is a child of the span named
before the dot where that one is recorded (``lane.launch.pin`` of
``lane.launch``; ``submit.upload``, on the caller, has no ``submit``).
`Tracer.clock["perf_to_unix_ns"]`, the least of five readings of
``time_ns() - perf_counter_ns()``, puts a span on the clock of
`torch.profiler`'s events (Unix nanoseconds).

The points are the runner's stage marks: (event, batch, `perf_counter`
seconds, ...) tuples in time order, ``stats["timeline"]``.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import Optional

NULL = contextlib.nullcontext()

_SPAN_IDS = itertools.count(1)
_CALL_IDS = itertools.count(1)
_LOCAL = threading.local()  # .stack: the spans open on this thread, innermost last


def enabled() -> bool:
    """Whether ``FLACENC_TIMELINE`` switches tracing on."""
    return bool(os.environ.get("FLACENC_TIMELINE"))


def perf_to_unix_ns() -> int:
    """Nanoseconds to add to a `perf_counter_ns` stamp to read it on the
    Unix clock, the least of five readings (the one least delayed between
    its two clock reads)."""
    return min(time.time_ns() - time.perf_counter_ns() for _ in range(5))


def span(tracer: Optional["Tracer"], name: str, seq=None, cpu: bool = False):
    """`tracer.span(name, seq, cpu)`, or `NULL` without a tracer."""
    if tracer is None:
        return NULL
    return tracer.span(name, seq, cpu)


class Span:
    """A span being timed: a context manager on the thread it times."""

    __slots__ = ("tracer", "name", "seq", "cpu", "id", "parent", "t0", "c0")

    def __init__(self, tracer: "Tracer", name: str, seq, cpu: bool):
        self.tracer, self.name, self.seq, self.cpu = tracer, name, seq, cpu
        self.id = next(_SPAN_IDS)
        self.parent = None

    def __enter__(self) -> "Span":
        stack = _LOCAL.__dict__.setdefault("stack", [])
        self.parent = stack[-1].id if stack else None
        stack.append(self)
        self.c0 = time.thread_time_ns() if self.cpu else None
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        cpu = None if self.c0 is None else time.thread_time_ns() - self.c0
        _LOCAL.stack.pop()
        self.tracer._add(self.id, self.parent, self.name, self.seq, self.t0, t1, cpu)
        return False


class Tracer:
    """One call's spans and points."""

    def __init__(self):
        self.call = next(_CALL_IDS)
        self.clock = {"perf_to_unix_ns": perf_to_unix_ns()}
        self.points: list = []
        # appended without a lock (one `deque.append` or `list(deque)` holds
        # the interpreter lock throughout): a contended lock at every span's
        # end would hand the interpreter lock to another thread there
        self._spans: collections.deque = collections.deque()
        # points are stamped and appended under one lock, so that the list
        # is in time order across threads
        self._lock = threading.Lock()

    def span(self, name: str, seq=None, cpu: bool = False) -> Span:
        return Span(self, name, seq, cpu)

    def record(self, name: str, seq, t0_ns: int) -> None:
        """A span without a parent from `t0_ns` (a `perf_counter_ns` stamp,
        maybe taken on another thread) to now, on this thread."""
        self._add(next(_SPAN_IDS), None, name, seq, t0_ns, time.perf_counter_ns(), None)

    def _add(self, sid, parent, name, seq, t0, t1, cpu) -> None:
        self._spans.append((sid, parent, name, self.call, seq, threading.current_thread().name,
                            t0, t1, cpu))

    def mark(self, event: str, idx, *extra) -> None:
        """A point event, (event, idx, perf_counter seconds) + extra."""
        with self._lock:
            self.points.append((event, idx, time.perf_counter()) + extra)

    def report(self) -> dict:
        """``spans`` (as dicts) and ``trace_clock``."""
        keys = ("id", "parent", "name", "call", "seq", "thread", "start_ns", "end_ns", "cpu_ns")
        return {"spans": [dict(zip(keys, r)) for r in list(self._spans)],
                "trace_clock": dict(self.clock)}
