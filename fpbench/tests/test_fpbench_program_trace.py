"""``fpbench/program_trace.py`` on synthetic kineto-like events: which
program span a kernel, a copy or an idle gap is put down to, what stays
unattributed, and the per-layer numbers read from it; ``fpbench/trace.py``
not counting the profiler's copies of program ranges as the card's work.
And the harness's runs leave the program's tracer off."""

import dataclasses
import types

import pytest
import torch

from fpbench import flops, program_trace, run, trace
from fpbench.tests.test_fpbench_harness import tiny_cell, tiny_run
from pfann_tpu_torch.utils import profiling
from pfann_tpu_torch.utils.profiling import Record

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
TID = 4242
US = 1000  # ns


class OldEv:
    """A kineto event as torch before ``activity_type()`` gives it."""

    def __init__(self, name, start, dur, device=CPU, kind="user_annotation", corr=0):
        self._v = (name, start, dur, device, kind, corr)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[5]



class Ev(OldEv):
    def activity_type(self):
        return self._v[4]

    def old(self):
        return OldEv(*self._v)


def launch(corr, t, name="k", start=None, dur=10 * US):
    """A runtime call at ``t`` and its kernel on the card."""
    return [Ev("cudaLaunchKernel", t, 2 * US, kind="cuda_runtime", corr=corr),
            Ev(name, t + 5 * US if start is None else start, dur, CUDA, "kernel", corr)]


def rec(name, start, end, parent=-1, n=None, thread=TID):
    return Record(name, start * US, end * US, parent, thread, n)


# db.query_top1_batch [0, 1000) us > db.filters [10, 200), db.engine
# [200, 900) > screen.stage3 [300, 800), and db.merge [900, 990)
RECS = [rec("db.query_top1_batch", 0, 1000, n=8), rec("db.filters", 10, 200, 0),
        rec("db.engine", 200, 900, 0), rec("screen.stage3", 300, 800, 2, n=2),
        rec("db.merge", 900, 990, 0)]


def events(*extra):
    return [Ev("window", 0, 2000 * US), Ev("search", 0, 1000 * US), *extra]


@pytest.mark.parametrize("torch_had_activity_type", [True, False])
def test_kernel_goes_to_the_innermost_span(torch_had_activity_type):
    ev = events(*launch(1, 400 * US, "align_reduce_wgmma", start=400 * US, dur=100 * US),
                *launch(2, 250 * US, "sort", start=510 * US, dur=40 * US),
                *launch(3, 50 * US, "Memcpy HtoD", start=560 * US, dur=40 * US),
                # the profiler's copy of a range on the card's timeline, with
                # a correlation id of another numbering: not device work
                Ev("screen.stage3", 400 * US, 150 * US, CUDA, "gpu_user_annotation", corr=2),
                Ev("search", 0, 1000 * US, CUDA, "gpu_user_annotation", corr=3))
    if not torch_had_activity_type:
        ev = [e.old() for e in ev]
        assert not hasattr(ev[0], "activity_type")
    pt = program_trace.read_events(ev, RECS)
    assert pt.device_by_span == pytest.approx(
        {"screen.stage3": 100e-6, "db.engine": 40e-6, "db.filters": 40e-6})
    assert pt.kernels_by_span["screen.stage3"] == {"align_reduce_wgmma": pytest.approx(100e-6)}
    assert pt.device_by_bench_span == {"search": pytest.approx({"screen": 100e-6, "db": 80e-6})}


def test_what_has_no_span_or_no_runtime_call_is_unattributed():
    orphan = Ev("k2", 1500 * US, 20 * US, CUDA, "kernel", corr=9)  # no runtime event
    ev = events(*launch(1, 1200 * US, start=1300 * US), orphan,
                Ev("Memcpy DtoH", 1600 * US, 5 * US, CUDA, "gpu_memcpy", corr=10))
    pt = program_trace.read_events(ev, RECS)
    assert pt.device_by_span == {program_trace.UNATTRIBUTED: pytest.approx(35e-6)}
    # with no program records at all, everything is unattributed
    pt = program_trace.read_events(events(*launch(1, 100 * US)), [])
    assert list(pt.device_by_span) == [program_trace.UNATTRIBUTED]


def test_spans_of_another_thread_nest_apart():
    # a span open on another thread from 0 to 2000 us: before screen.stage3
    # opens (300 us) it is the innermost to start last; inside stage3 the
    # stage is, and after the main thread's spans have closed it is again
    recs = [rec("embedder.encoder", 250, 2000, thread=77)] + RECS
    recs = [r._replace(parent=r.parent + 1 if r.parent >= 0 else -1) for r in recs]
    pt = program_trace.read_events(events(*launch(1, 280 * US), *launch(2, 400 * US),
                                          *launch(3, 1100 * US), *launch(4, 100 * US)), recs)
    assert pt.device_by_span == pytest.approx({"embedder.encoder": 20e-6,
                                               "screen.stage3": 10e-6, "db.filters": 10e-6})


def test_idle_gap_under_filters_counts_as_host_prep():
    # busy [150, 160) and [300, 2000) us: the gaps are [0, 150) (midpoint 75,
    # under db.filters) and [160, 300) (midpoint 230, under db.engine)
    ev = events(*launch(1, 100 * US, start=150 * US, dur=10 * US),
                *launch(2, 250 * US, start=300 * US, dur=1700 * US))
    pt = program_trace.read_events(ev, RECS)
    assert pt.idle_by_span == pytest.approx({"db.filters": 150e-6, "db.engine": 140e-6})
    assert [n for n, _ in pt.idle_gaps] == ["db.filters", "db.engine"]
    assert program_trace.host_prep_idle_pct(pt) == pytest.approx(100 * 150e-6 / 2e-3)


def test_readings():
    ev = events(*launch(1, 400 * US, "align_reduce_wgmma", start=400 * US, dur=100 * US),
                *launch(2, 420 * US, "argmax", start=500 * US, dur=20 * US),
                Ev("screen.stage3", 300 * US + 7 * US, 500 * US))
    pt = program_trace.read_events(ev, RECS)
    assert program_trace.device_ms(pt, "screen.stage3", 2) == pytest.approx(0.06)
    assert program_trace.host_ms(pt, "db.filters", 2) == pytest.approx(0.095)
    cfg = {"n_songs": 100, "song_rows": 120, "model": {"d": 64}}
    tr = {"query_rows": 19}
    bound = flops.align_bound_s(19, 64, 2, 12000, 100)
    assert program_trace.stage3_roofline(pt, cfg, tr) == pytest.approx(100 * bound / 100e-6)
    assert program_trace.clock_gap_us(pt) == pytest.approx((7.0, 7.0))
    table = program_trace.span_table(profiling.summary(RECS), pt)
    assert table["screen.stage3"]["device_s"] == pytest.approx(120e-6)
    assert table["db.query_top1_batch"]["n"] == 8


def test_readings_are_none_without_a_trace_or_their_spans():
    cfg = {"n_songs": 100, "song_rows": 120, "model": {"d": 64}}
    tr = {"query_rows": 19}
    for pt in (None, program_trace.read_events(events(*launch(1, 100 * US)), [])):
        assert program_trace.device_ms(pt, "embedder.melspec", 3) is None
        assert program_trace.device_ms(pt, "screen.stage3", 3) is None
        assert program_trace.host_ms(pt, "db.filters", 3) is None
        assert program_trace.stage3_roofline(pt, cfg, tr) is None
        assert program_trace.host_prep_idle_pct(pt) is None
    pt = program_trace.read_events(events(*launch(1, 100 * US)), RECS)
    assert program_trace.device_ms(pt, "embedder.encoder", 3) is None
    assert program_trace.stage3_roofline(pt, cfg, tr) is None  # no align_reduce in it
    assert program_trace.clock_gap_us(pt) is None


def fake_prof(ev):
    """What ``read_trace`` reads of a finished ``torch.profiler.profile``."""
    results = types.SimpleNamespace(events=lambda: ev)
    return types.SimpleNamespace(profiler=types.SimpleNamespace(kineto_results=results))


@pytest.mark.parametrize("torch_had_activity_type", [True, False])
def test_read_trace_skips_the_program_ranges_on_the_card(torch_had_activity_type):
    """The profiler's copies of program ranges on the card's timeline are no
    device work once ``read_trace`` has the program's span names; without
    program spans it reads what it read before they existed."""
    work = events(*launch(1, 400 * US, "align_reduce_wgmma", start=400 * US, dur=100 * US),
                  *launch(2, 600 * US, "sort", start=700 * US, dur=50 * US))
    copies = [Ev("screen.stage3", 300 * US, 500 * US, CUDA, "gpu_user_annotation", corr=2),
              Ev("db.filters", 10 * US, 190 * US, CUDA, "gpu_user_annotation", corr=8)]
    if not torch_had_activity_type:
        work, copies = [e.old() for e in work], [e.old() for e in copies]
    names = {r.name for r in RECS}
    before = trace.read_trace(fake_prof(work))
    assert before.busy_s == pytest.approx(150e-6)
    assert trace.read_trace(fake_prof(work), names) == before
    got = trace.read_trace(fake_prof(work + copies), names)
    # the same reading; only the list of device-side kinds seen grows
    assert dataclasses.replace(got, activities=before.activities) == before
    assert not names & {n for n, _ in got.device_ops}
    if not torch_had_activity_type:
        # what the spans' names are needed for: by kind alone, the copies
        # read as kernels
        assert trace.read_trace(fake_prof(work + copies)).busy_s > before.busy_s


def test_idle_gap_outside_program_spans_takes_the_benchmark_span():
    # db.filters [10, 200) us under search [0, 1000); busy [300, 400) and
    # [700, 1500): the gap [0, 300) has its midpoint under db.filters,
    # [400, 700) under search alone, [1500, 2000) under no span
    recs = [rec("db.filters", 10, 200)]
    ev = events(*launch(1, 250 * US, start=300 * US, dur=100 * US),
                *launch(2, 600 * US, start=700 * US, dur=800 * US))
    pt = program_trace.read_events(ev, recs)
    assert pt.idle_by_span == pytest.approx(
        {"db.filters": 300e-6, "search": 300e-6, trace.HOST_IDLE: 500e-6})
    assert [n for n, _ in pt.idle_gaps] == [trace.HOST_IDLE, "db.filters", "search"]
    # with no program spans the gaps carry the names read_trace gives them
    assert (program_trace.read_events(ev, []).idle_gaps
            == trace.read_trace(fake_prof(ev)).idle_gaps)


CFG = {"n_songs": 100, "song_rows": 120, "model": {"d": 64}}
TR = {"query_rows": 19}


@pytest.mark.parametrize("name,want", [
    ("encoder_ms", 0.1), ("melspec_ms", 0.015), ("search_filters_ms", 0.095),
    ("stage3_ms", 0.05),
    ("stage3_roofline", 100 * flops.align_bound_s(19, 64, 2, 12000, 100) / 100e-6),
    # the gap [0, 350) us under db.filters, of a 2,000 us window
    ("host_prep_idle_pct", 17.5)])
def test_program_metric_readers(name, want):
    """Each reader of the program's spans reads its helper on the traced
    window, and nothing from a run without a program trace."""
    recs = RECS + [rec("embedder.melspec", 1000, 1100), rec("embedder.encoder", 1100, 1500)]
    ev = events(*launch(1, 340 * US, "align_reduce_wgmma", start=350 * US, dur=100 * US),
                *launch(2, 1050 * US, "mel_gemm", start=1060 * US, dur=30 * US),
                *launch(3, 1200 * US, "conv", start=1200 * US, dur=200 * US),
                *launch(4, 1600 * US, "harness_op", start=1610 * US, dur=390 * US))
    pt = program_trace.read_events(ev, recs)
    cell = types.SimpleNamespace(config=CFG, traffic=TR)
    got = run.read_metric(name, types.SimpleNamespace(program=pt, batches=2, cell=cell))
    assert got == pytest.approx(want)
    assert run.read_metric(name, types.SimpleNamespace(program=None, batches=2, cell=cell)) is None


def test_a_trace_needs_its_window():
    with pytest.raises(RuntimeError):
        program_trace.read_events([Ev("search", 0, 10)], RECS)


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("traffic", ["tiny-audio", "tiny-rows"])
def test_benchmark_run_leaves_the_program_tracer_off(traffic, traced):
    """A run leaves the tracer off; a ``--trace 0`` run records no span, a
    ``--trace 1`` run those of its window, and reads them."""
    profiling.enable()
    profiling.disable()
    out = tiny_run(tiny_cell(traffic), trace=traced)
    assert out["correct"] is True
    assert profiling.span("x") is profiling.span("y")
    if traced:
        info = out["info"]
        assert profiling.records() and info["program_dropped"] == 0
        assert info["program_spans"]["db.query_top1_batch"]["calls"] == info["batches"]
        assert ("embedder.embed_songs" in info["program_spans"]) == (traffic == "tiny-audio")
    else:
        assert profiling.records() == []
