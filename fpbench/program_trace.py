"""The program's own spans against the card's work in a traced window.

The program records spans at its layer boundaries
(``pfann_tpu_torch.utils.profiling``: ``enable()``, ``records()``, in
epoch nanoseconds, the clock of ``torch.profiler``'s kineto events).  This
module puts down to those spans what the profiler saw on the card in the
window (the benchmark's ``window`` range):

- each kernel and copy to the innermost program span open when its
  runtime call (``cudaLaunchKernel``, ``cuLaunchKernel``,
  ``cudaMemcpyAsync``, ...; joined by the correlation id the two events
  share) started.  Kineto numbers a runtime call's thread its own way, not
  by the system's thread id the records carry, so where spans on several
  threads are open at once, the one that opened last takes it: the
  benchmark's loop runs on one thread;
- each idle gap of the card to the innermost program span open at the
  gap's midpoint; where none is, to the benchmark's span open then
  (``embed``, ``search``), or to the harness's own host time.

Device work it cannot put down (no runtime call, no span open) is
``UNATTRIBUTED``.  Nothing here imports the program: a run that has no
program spans reads as all unattributed, and its gaps are named as
``fpbench.trace`` names them.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import statistics

import torch

from fpbench import flops
from fpbench.trace import DEVICE_ACTIVITIES, HOST_IDLE, TOP, WINDOW, _union

UNATTRIBUTED = "unattributed"
# the benchmark's own spans around its calls into the program
BENCH_SPANS = ("embed", "search")
RUNTIME_ACTIVITIES = ("cuda_runtime", "cuda_driver")
# spans of host work that feeds the card: packing, uploads, the filters,
# the answer list
HOST_PREP_SPANS = ("embedder.pack", "embedder.upload", "db.filters", "db.merge",
                   "align.upload", "screen.upload")


@dataclasses.dataclass
class ProgramTrace:
    window_s: float
    records: list  # the program's records (profiling.Record), as given
    device_by_span: dict  # span name -> device seconds launched inside it
    kernels_by_span: dict  # span name -> {kernel or copy name: device seconds}
    # span name (the benchmark's or the harness's where no program span
    # is open) -> idle seconds of the window under it
    idle_by_span: dict
    idle_gaps: list  # the TOP (span name, seconds) longest idle gaps
    # benchmark span -> {first part of the program span's name: device seconds}
    device_by_bench_span: dict
    clock_gaps_ns: list  # record start less its record_function event's start


def _activity(e, name: str, ranges: set) -> str:
    """The event's activity type.  Older torch has no ``activity_type()``:
    there a range (the benchmark's or the program's, which the profiler
    copies onto the card's timeline too) is known by its name."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    if e.device_type() == torch.autograd.DeviceType.CUDA:
        return ("gpu_user_annotation" if name in ranges
                else "gpu_memcpy" if name.startswith("Memcpy")
                else "gpu_memset" if name.startswith("Memset") else "kernel")
    return ("user_annotation" if name in ranges
            else "cuda_runtime" if name.startswith("cu") else "cpu_op")


class _Innermost:
    """The innermost record holding a time.  Records on one thread nest (a
    thread-local stack made their parents), so there it is the last one
    that started by then, or one of its ancestors."""

    def __init__(self, recs: list):
        self.recs = recs
        by_thread = collections.defaultdict(list)
        for i, r in enumerate(recs):
            by_thread[r.thread].append(i)
        self.threads = {}
        for th, idx in by_thread.items():
            idx.sort(key=lambda i: recs[i].start_ns)
            self.threads[th] = (idx, [recs[i].start_ns for i in idx])

    def _on(self, thread, t: int):
        idx, starts = self.threads[thread]
        j = bisect.bisect_right(starts, t) - 1
        i = idx[j] if j >= 0 else -1
        while i >= 0:
            end = self.recs[i].end_ns
            if end is None or end > t:
                return i
            i = self.recs[i].parent
        return -1

    def at(self, t: int) -> int:
        """Index of the innermost record open at ``t`` (of those on several
        threads, the latest to start), or -1."""
        best = -1
        for th in self.threads:
            i = self._on(th, t)
            if i >= 0 and (best < 0 or self.recs[i].start_ns > self.recs[best].start_ns):
                best = i
        return best


def read_events(events, recs: list) -> ProgramTrace:
    """Attribute a window's device work and idle gaps to the records."""
    cuda = torch.autograd.DeviceType.CUDA
    window = None
    device, runtime, annotations, bench = [], {}, collections.defaultdict(list), []
    names = {r.name for r in recs}
    ranges = names | {WINDOW, *BENCH_SPANS}
    for e in events:
        name = e.name()
        kind = _activity(e, name, ranges)
        start = e.start_ns()
        if e.device_type() == cuda:
            if kind in DEVICE_ACTIVITIES:
                device.append((start, start + e.duration_ns(), name, e.correlation_id()))
        elif kind in RUNTIME_ACTIVITIES:
            runtime[e.correlation_id()] = start
        elif name == WINDOW:
            window = (start, start + e.duration_ns())
        elif name in BENCH_SPANS:
            bench.append((start, start + e.duration_ns(), name))
        elif name in names:
            annotations[name].append(start)
    if window is None:
        raise RuntimeError("the trace holds no %r range" % WINDOW)
    w0, w1 = window
    for starts in annotations.values():
        starts.sort()
    spans = _Innermost(recs)
    bench.sort()
    bench_starts = [b[0] for b in bench]

    def name_of(i):
        return recs[i].name if i >= 0 else UNATTRIBUTED

    def bench_at(t):
        j = bisect.bisect_right(bench_starts, t) - 1
        return bench[j][2] if j >= 0 and bench[j][1] > t else UNATTRIBUTED

    def gap_name(t):
        i = spans.at(t)
        if i >= 0:
            return recs[i].name
        b = bench_at(t)
        return HOST_IDLE if b == UNATTRIBUTED else b

    device_by = collections.Counter()
    kernels_by = collections.defaultdict(collections.Counter)
    by_bench = collections.defaultdict(collections.Counter)
    inside = []
    for s, e, name, corr in device:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        inside.append([s, e])
        sec = (e - s) / 1e9
        launch = runtime.get(corr)
        span = UNATTRIBUTED if launch is None else name_of(spans.at(launch))
        device_by[span] += sec
        kernels_by[span][name] += sec
        if launch is not None:
            by_bench[bench_at(launch)][span.split(".")[0]] += sec
    idle_by = collections.Counter()
    gaps_named = []
    prev = w0
    for s, e in _union(inside) + [[w1, w1]]:
        if s > prev:
            gaps_named.append((gap_name((prev + s) // 2), (s - prev) / 1e9))
            idle_by[gaps_named[-1][0]] += gaps_named[-1][1]
        prev = max(prev, e)
    gaps = []
    for r in recs:
        starts = annotations.get(r.name)
        if starts and w0 <= r.start_ns <= w1:
            j = bisect.bisect_left(starts, r.start_ns)
            near = [starts[k] for k in (j - 1, j) if 0 <= k < len(starts)]
            gaps.append(min((r.start_ns - s for s in near), key=abs))
    return ProgramTrace(
        window_s=(w1 - w0) / 1e9, records=recs, device_by_span=dict(device_by),
        kernels_by_span={k: dict(v) for k, v in kernels_by.items()},
        idle_by_span=dict(idle_by),
        idle_gaps=[list(g) for g in sorted(gaps_named, key=lambda g: -g[1])[:TOP]],
        device_by_bench_span={k: dict(v) for k, v in by_bench.items()},
        clock_gaps_ns=gaps,
    )


def read(prof, recs: list) -> ProgramTrace:
    """``read_events`` of a finished ``torch.profiler.profile``."""
    return read_events(prof.profiler.kineto_results.events(), recs)


def span_table(summary: dict, pt: ProgramTrace) -> dict:
    """The program's summary per span name (calls, host_s, self_s, n) with
    the device seconds launched inside each."""
    return {name: {**s, "device_s": pt.device_by_span.get(name, 0.0)}
            for name, s in summary.items()}


def clock_gap_us(pt: ProgramTrace):
    """(median, largest) |record start - its record_function event's
    start| in microseconds, or None where no record had one."""
    if not pt.clock_gaps_ns:
        return None
    g = [abs(x) / 1e3 for x in pt.clock_gaps_ns]
    return statistics.median(g), max(g)


def _calls(pt: ProgramTrace, name: str) -> list:
    return [r for r in pt.records if r.name == name and r.end_ns is not None]


def device_ms(pt: ProgramTrace | None, name: str, batches: int):
    """Device ms a batch of the kernels and copies launched inside the
    span ``name``; None where the span never ran or the window saw no
    device work (a run without a card)."""
    if pt is None or not batches or not pt.device_by_span or not _calls(pt, name):
        return None
    return 1e3 * pt.device_by_span.get(name, 0.0) / batches


def host_ms(pt: ProgramTrace | None, name: str, batches: int):
    """Host ms a batch inside the span ``name``; None where it never ran."""
    calls = _calls(pt, name) if pt is not None else []
    if not calls or not batches:
        return None
    return sum(r.end_ns - r.start_ns for r in calls) / 1e6 / batches


def stage3_roofline(pt: ProgramTrace | None, cfg: dict, tr: dict):
    """The screen's stage-3 least time over the device time of the
    ``align_reduce`` kernels launched inside ``screen.stage3``: each call
    rescans its ``n`` escalated queries of the traffic's rows against the
    catalogue's own rows (not the layout's padded rows or the kernel's
    query tile)."""
    if pt is None:
        return None
    calls = [r for r in _calls(pt, "screen.stage3") if r.n]
    busy = sum(t for k, t in pt.kernels_by_span.get("screen.stage3", {}).items()
               if "align_reduce" in k)
    if not calls or busy <= 0:
        return None
    rows = cfg["n_songs"] * cfg["song_rows"]
    bound = sum(flops.align_bound_s(tr["query_rows"], cfg["model"]["d"], r.n, rows,
                                    cfg["n_songs"]) for r in calls)
    return 100.0 * bound / busy


def host_prep_idle_pct(pt: ProgramTrace | None):
    """100 x the window's idle seconds under the host's preparation spans
    over the window's seconds; None where the program recorded no span or
    the window saw no device work."""
    if pt is None or not pt.records or not pt.device_by_span or pt.window_s <= 0:
        return None
    return 100.0 * sum(pt.idle_by_span.get(n, 0.0) for n in HOST_PREP_SPANS) / pt.window_s
