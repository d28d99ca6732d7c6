"""The benchmark's spans and its reading of ``torch.profiler``'s trace.

Spans are the benchmark's own, around its calls into the program's layers
(``embed``, ``search``); the whole measured loop is the span ``window``.
Under ``--trace 1`` each span is also a ``record_function`` range, so the
trace's host events and the card's kernels and copies share one clock.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import time

import torch

# activity types of work on the card; annotations and runtime calls are not
DEVICE_ACTIVITIES = ("kernel", "concurrent_kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "window"
SPAN_NAMES = (WINDOW, "embed", "search")
HOST_IDLE = "harness"  # what the host did when no span was open
TOP = 10


class Spans:
    """Host-clock durations of named spans; with ``traced`` each span is a
    profiler range too."""

    def __init__(self, traced: bool):
        self.traced = traced
        self.seconds: dict[str, list[float]] = collections.defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name: str):
        ctx = (torch.profiler.record_function(name) if self.traced
               else contextlib.nullcontext())
        t0 = time.perf_counter()
        with ctx:
            yield
        self.seconds[name].append(time.perf_counter() - t0)


@dataclasses.dataclass
class Trace:
    window_s: float  # the traced window, on the trace's clock
    busy_s: float  # the union of the card's kernels and copies in it
    kernels: list  # (name, seconds) of every kernel in the window
    device_ops: list  # the TOP (name, seconds) totals
    idle_gaps: list  # the TOP (span open on the host, seconds) gaps
    idle_by_span: dict  # idle seconds by the span open on the host
    activities: list  # the device-side activity types seen


def _union(intervals):
    """Sorted, merged [start, end] intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read_trace(prof, program_spans=()) -> Trace:
    """The window's device busy time, kernel totals and idle gaps from a
    finished profiler.  ``program_spans`` names the program's own spans
    that the window recorded: they are profiler ranges too, never the
    card's work."""
    events = prof.profiler.kineto_results.events()
    ranges = set(SPAN_NAMES).union(program_spans)
    window = None
    spans, device, seen = [], [], set()
    cuda = torch.autograd.DeviceType.CUDA
    for e in events:
        name = e.name()
        # older torch has no activity_type(); there a range (the
        # benchmark's span or the program's, which the profiler copies onto
        # the device's timeline too) is known by its name
        kind = e.activity_type() if hasattr(e, "activity_type") else (
            "annotation" if name in ranges else "gpu_memcpy" if name.startswith("Memcpy")
            else "gpu_memset" if name.startswith("Memset") else "kernel")
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        if e.device_type() == cuda:
            seen.add(kind)
            if kind in DEVICE_ACTIVITIES:
                device.append((start, end, name, kind))
        elif name in SPAN_NAMES:
            if name == WINDOW:
                window = (start, end)
            else:
                spans.append((start, end, name))
    if window is None:
        raise RuntimeError("the trace holds no %r range" % WINDOW)
    w0, w1 = window
    inside = [(max(s, w0), min(e, w1), n, k) for s, e, n, k in device if e > w0 and s < w1]
    busy = _union([[s, e] for s, e, _, _ in inside])
    totals = collections.Counter()
    kernels = []
    for s, e, n, k in inside:
        totals[n] += (e - s) / 1e9
        if k in ("kernel", "concurrent_kernel"):
            kernels.append((n, (e - s) / 1e9))
    gaps, prev = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    spans.sort()  # the benchmark's spans follow one another, never nest
    starts = [s for s, _, _ in spans]

    def host_span(t):
        i = bisect.bisect_right(starts, t) - 1
        return spans[i][2] if i >= 0 and spans[i][1] >= t else HOST_IDLE

    named = [(host_span((s + e) // 2), (e - s) / 1e9) for s, e in gaps]
    by_span = collections.Counter()
    for n, sec in named:
        by_span[n] += sec
    return Trace(
        window_s=(w1 - w0) / 1e9,
        busy_s=sum(e - s for s, e in busy) / 1e9,
        kernels=kernels,
        device_ops=[[n[:160], t] for n, t in totals.most_common(TOP)],
        idle_gaps=[[n, t] for n, t in sorted(named, key=lambda g: -g[1])[:TOP]],
        idle_by_span=dict(by_span),
        activities=sorted(seen),
    )
