"""The port's tracing: named spans at its layer boundaries, and a
``torch.profiler`` wrapper.

``span(name, n=None)`` marks a region of the program.  Tracing is off
until ``enable()``: a span is then one shared null context, which reads no
clock and records nothing.  Once enabled, each span leaves a ``Record``:
its name, start and end in epoch nanoseconds (``time.perf_counter_ns()``
plus an offset fixed at ``enable()``, the clock ``torch.profiler``'s
kineto events carry, so the program's spans and the card's kernels share
one clock), the innermost span open on the same thread when it began (its
parent), the thread's native id and an optional item count ``n`` (a span
may set it before it closes: ``with span("x") as s: ...; s.n = k``).
While a ``torch.profiler`` is recording, a span also opens a
``record_function`` of its name, so the profiler's trace shows the
program's layers.  ``records()`` returns what was recorded since the last
``enable()``, ``summary()`` the totals per name.  At most ``CAPACITY``
records are kept; later spans are counted by ``dropped()``.

``device_trace`` wraps a region in ``torch.profiler`` with the CPU and
CUDA activities (CUDA where a card is visible) and writes a Chrome trace
(Perfetto, chrome://tracing) into ``log_dir``.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import NamedTuple

import torch

CAPACITY = 1 << 20  # records kept between enable() calls


class Record(NamedTuple):
    name: str
    start_ns: int  # epoch ns
    end_ns: int | None  # None while the span is still open
    parent: int  # index in records() of the enclosing span, -1 at a root
    thread: int  # threading.get_native_id() of the thread that opened it
    n: int | None  # items the span handled, where it says


class _NullSpan:
    """What ``span`` returns while tracing is off: one shared object."""

    __slots__ = ("n",)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


_NULL = _NullSpan()


class _Local(threading.local):
    def __init__(self):
        self.open = None  # the innermost open _Span on this thread
        # once a thread: it is a system call, microseconds on some hosts
        self.tid = threading.get_native_id()


class _Tracer:
    def __init__(self):
        self.on = False
        self.buf: list = []  # one [name, start, end, parent, thread, n] a span
        self.dropped = 0
        self.offset_ns = 0
        self.local = _Local()


_TRACER = _Tracer()
_profiler_recording = torch._C._autograd._profiler_enabled


class _Span:
    __slots__ = ("name", "n", "buf", "index", "outer", "rf")

    def __init__(self, name: str, n: int | None):
        self.name = name
        self.n = n

    def __enter__(self):
        self.rf = None
        if _profiler_recording():
            # the profiler's range opens first and closes last, so the
            # record lies inside it
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        tr = _TRACER
        start = time.perf_counter_ns() + tr.offset_ns
        local = tr.local
        outer = self.outer = local.open
        buf = tr.buf
        if len(buf) < CAPACITY:
            # an enclosing span opened before the last enable() wrote to
            # another buffer: this one is a root of the new one
            parent = outer.index if outer is not None and outer.buf is buf else -1
            self.buf, self.index = buf, len(buf)
            buf.append([self.name, start, None, parent, local.tid, self.n])
        else:
            self.buf = None
            tr.dropped += 1
        local.open = self
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns() + _TRACER.offset_ns
        if self.buf is not None:
            entry = self.buf[self.index]
            entry[2], entry[5] = end, self.n
        _TRACER.local.open = self.outer
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return None


def span(name: str, n: int | None = None):
    """A named region of the program; a no-op while tracing is off."""
    if not _TRACER.on:
        return _NULL
    return _Span(name, n)


def enable() -> None:
    """Start recording spans, from an empty buffer."""
    tr = _TRACER
    tr.buf = []
    tr.dropped = 0
    tr.offset_ns = time.time_ns() - time.perf_counter_ns()
    tr.on = True


def disable() -> None:
    """Stop recording; what was recorded stays readable."""
    _TRACER.on = False


def records() -> list[Record]:
    """The spans recorded since the last ``enable()``, in the order they
    opened."""
    return [Record(*e) for e in _TRACER.buf]


def dropped() -> int:
    """Spans not recorded since the last ``enable()``: the buffer was full."""
    return _TRACER.dropped


def summary(recs: list[Record] | None = None) -> dict:
    """Per span name: calls, host seconds, self seconds (less the time its
    child spans cover) and the summed ``n``, over finished spans."""
    recs = records() if recs is None else recs
    child_ns = [0] * len(recs)
    for r in recs:
        if r.end_ns is not None and r.parent >= 0:
            child_ns[r.parent] += r.end_ns - r.start_ns
    out: dict = {}
    for i, r in enumerate(recs):
        if r.end_ns is None:
            continue
        s = out.setdefault(r.name, {"calls": 0, "host_s": 0.0, "self_s": 0.0, "n": 0})
        dur = r.end_ns - r.start_ns
        s["calls"] += 1
        s["host_s"] += dur / 1e9
        s["self_s"] += (dur - child_ns[i]) / 1e9
        s["n"] += r.n or 0
    return out


@contextlib.contextmanager
def device_trace(log_dir: str = "profiles", enabled: bool = True):
    """torch.profiler around a region; yields the profiler (None when
    disabled) and, on exit, writes ``log_dir/trace_<pid>_<ns>.json``."""
    if not enabled:
        yield None
        return
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, "trace_%d_%d.json" % (os.getpid(), time.time_ns())))
