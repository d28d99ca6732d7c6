"""The port's span tracer (``utils/profiling.py``) and the spans at its
serving path's layer boundaries: ``Embedder.embed_songs``,
``Database.query_top1_batch`` and the exhaustive and screened engines
under it, on the CPU.

Off, a span is one shared null context and records nothing; on, each
span leaves a record with its parent, thread and item count, the span
tree of each path is the one named here, self times add up to the roots'
times, answers do not change, and under ``torch.profiler`` the records
start within 1 ms of their ``record_function`` events (one clock).
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

from pfann_tpu_torch.index.database import Database, write_index_meta
from pfann_tpu_torch.index.embedder import Embedder
from pfann_tpu_torch.models.fp_network import build_fp_network
from pfann_tpu_torch.utils import profiling
from pfann_tpu_torch.utils.checkpoint import save_model

TINY = {
    "sample_rate": 1000, "stft_n": 128, "stft_hop": 32, "n_mels": 32,
    "f_min": 50, "f_max": 450, "segment_size": 1, "hop_size": 0.5,
    "model": {"d": 16, "h": 32, "u": 4},
}
D = 16
ALIGN_TREE = {
    "db.query_top1_batch": None,
    "db.filters": "db.query_top1_batch",
    "db.engine": "db.query_top1_batch",
    "db.merge": "db.query_top1_batch",
    "align.upload": "db.engine",
    "align.scan": "db.engine",
    "align.fetch": "db.engine",
}
SCREEN_TREE = {
    "db.query_top1_batch": None,
    "db.filters": "db.query_top1_batch",
    "db.engine": "db.query_top1_batch",
    "db.merge": "db.query_top1_batch",
    "screen.upload": "db.engine",
    "screen.stage1": "db.engine",
    "screen.sort": "db.engine",
    "screen.stage2": "db.engine",
    "screen.gate": "db.engine",
    "screen.stage3": "db.engine",
    "screen.fetch": "db.engine",
}
EMBED_TREE = {
    "embedder.embed_songs": None,
    "embedder.pack": "embedder.embed_songs",
    "embedder.upload": "embedder.embed_songs",
    "embedder.melspec": "embedder.embed_songs",
    "embedder.encoder": "embedder.embed_songs",
    "embedder.gather": "embedder.embed_songs",
}


@pytest.fixture(autouse=True)
def tracing_off():
    profiling.disable()
    yield
    profiling.disable()


@pytest.fixture(scope="module")
def db_dir(tmp_path_factory):
    """12 songs of 20-40 unit rows."""
    root = str(tmp_path_factory.mktemp("db"))
    rng = np.random.default_rng(15)
    counts = rng.integers(20, 40, size=12).astype(np.int32)
    emb = rng.standard_normal((int(counts.sum()), D)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    emb.tofile(os.path.join(root, "embeddings"))
    counts.tofile(os.path.join(root, "landmarkKey"))
    with open(os.path.join(root, "songList.txt"), "w") as f:
        f.writelines("s%d.wav\n" % i for i in range(len(counts)))
    write_index_meta(root, d=D)
    return root, emb, counts


def _queries(emb, counts, rng):
    """Five crops of 9 rows with a little noise, and one query of noise,
    which the screen's rescue gate sends to stage 3."""
    pos = np.pad(np.cumsum(counts), (1, 0))
    out = []
    for s in (0, 3, 5, 8, 11):
        q = emb[pos[s] + 4 : pos[s] + 13] + 0.05 * rng.standard_normal((9, D))
        out.append((q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32))
    noise = rng.standard_normal((9, D)).astype(np.float32)
    out.append(noise / np.linalg.norm(noise, axis=1, keepdims=True))
    return out


def _database(db_dir, engine):
    params = {"top_k": 5, "db_dtype": "float32", "backend": "exact",
              "screen": engine == "screen", "screen_top_m": 2}
    return Database(db_dir[0], params, 0.5, "cpu")


@pytest.fixture(scope="module")
def embedder(tmp_path_factory):
    torch.manual_seed(0)
    path = str(tmp_path_factory.mktemp("m") / "model.msgpack")
    save_model(path, build_fp_network(TINY).state_dict())
    # chunk 8: up to 4 x 8 windows a call, six songs of 5 windows
    return Embedder(TINY, path, "cpu", compute_dtype=torch.float32, chunk=8)


def _songs(seed=0, n=3, seconds=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(-20000, 20000, seconds * 1000).astype(np.int16) for _ in range(n)]


def _tree(recs):
    """{name: parent's name} and {name: calls} of a list of records."""
    parents, calls = {}, {}
    for r in recs:
        p = recs[r.parent].name if r.parent >= 0 else None
        assert parents.setdefault(r.name, p) == p, r.name
        calls[r.name] = calls.get(r.name, 0) + 1
    return parents, calls


def test_span_off_is_one_shared_null_context():
    assert profiling.span("a") is profiling.span("b", n=3)
    profiling.enable()
    profiling.disable()
    with profiling.span("x") as s:
        s.n = 4
        with profiling.span("y"):
            pass
    assert profiling.records() == [] and profiling.summary() == {}
    assert profiling.dropped() == 0


def test_records_nest_per_thread_and_enable_starts_afresh():
    profiling.enable()
    with profiling.span("root", n=2):
        with profiling.span("a") as a:
            a.n = 7
        seen = []
        t = threading.Thread(target=lambda: seen.append(profiling.span("t").__enter__()))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        seen[0].__exit__(None, None, None)
    recs = profiling.records()
    assert [r.name for r in recs] == ["root", "a", "t"]
    root, a, th = recs
    assert (root.parent, a.parent, th.parent) == (-1, 0, -1)  # another thread's root
    assert (root.n, a.n, th.n) == (2, 7, None)
    assert root.thread == a.thread == threading.get_native_id() != th.thread
    assert root.start_ns <= a.start_ns <= a.end_ns <= root.end_ns
    # epoch nanoseconds
    assert abs(root.start_ns - time.time_ns()) < 60e9
    with profiling.span("open"):
        profiling.enable()
        with profiling.span("inner"):
            pass
    assert [(r.name, r.parent) for r in profiling.records()] == [("inner", -1)]


def test_full_buffer_counts_dropped(monkeypatch):
    monkeypatch.setattr(profiling, "CAPACITY", 3)
    profiling.enable()
    for _ in range(5):
        with profiling.span("s"):
            pass
    assert len(profiling.records()) == 3 and profiling.dropped() == 2
    assert profiling.summary()["s"]["calls"] == 3


@pytest.mark.parametrize("engine", ["align", "screen"])
def test_database_span_tree_and_answers(db_dir, engine):
    rng = np.random.default_rng(1)
    queries = _queries(db_dir[1], db_dir[2], rng)
    db = _database(db_dir, engine)
    off = db.query_top1_batch(queries)
    esc0 = getattr(db._align, "escalated", 0)
    profiling.enable()
    on = db.query_top1_batch(queries)
    profiling.disable()
    assert on == off
    recs = profiling.records()
    parents, calls = _tree(recs)
    assert parents == (ALIGN_TREE if engine == "align" else SCREEN_TREE)
    assert set(calls.values()) == {1}
    by = {r.name: r for r in recs}
    assert by["db.query_top1_batch"].n == len(queries)
    if engine == "screen":
        esc = db._align.escalated - esc0
        assert esc >= 1
        assert by["screen.gate"].n == by["screen.stage3"].n == esc
    # children in the order they ran, inside their parents
    for r in recs:
        if r.parent >= 0:
            p = recs[r.parent]
            assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns


@pytest.mark.parametrize("engine", ["align", "screen"])
def test_self_times_add_up(db_dir, engine):
    rng = np.random.default_rng(2)
    db = _database(db_dir, engine)
    profiling.enable()
    for _ in range(2):
        db.query_top1_batch(_queries(db_dir[1], db_dir[2], rng))
    profiling.disable()
    recs = profiling.records()
    summ = profiling.summary()
    root_ns = sum(r.end_ns - r.start_ns for r in recs if r.parent < 0)
    self_s = sum(s["self_s"] for s in summ.values())
    assert self_s == pytest.approx(root_ns / 1e9, abs=1e-6)
    assert all(s["self_s"] >= 0 for s in summ.values())
    assert summ["db.query_top1_batch"]["calls"] == 2
    assert summ["db.query_top1_batch"]["n"] == 12
    assert summ["db.engine"]["host_s"] >= summ["db.engine"]["self_s"]


def test_embedder_span_tree_and_embeddings(embedder):
    songs = _songs()
    counts = [5, 5, 5]
    off = embedder.embed_songs(songs, counts, 500)
    profiling.enable()
    on = embedder.embed_songs(songs, counts, 500)
    profiling.disable()
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a, b)
    recs = profiling.records()
    parents, calls = _tree(recs)
    assert parents == EMBED_TREE
    # 4 * 8 // 5 = 6 songs a call: one call; at chunk 2, one song a call
    assert calls == {name: 1 for name in EMBED_TREE}
    assert recs[0].name == "embedder.embed_songs" and recs[0].n == 15
    embedder.chunk = 2
    try:
        profiling.enable()
        embedder.embed_songs(songs, counts, 500)
        profiling.disable()
    finally:
        embedder.chunk = 8
    _, calls = _tree(profiling.records())
    assert calls["embedder.embed_songs"] == 1
    assert {calls[n] for n in EMBED_TREE if n != "embedder.embed_songs"} == {3}


@pytest.mark.parametrize("path", ["align", "screen", "embedder"])
def test_records_share_the_profilers_clock(db_dir, embedder, path):
    rng = np.random.default_rng(3)
    profiling.enable()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("window"):
            if path == "embedder":
                embedder.embed_songs(_songs(4), [5, 5, 5], 500)
            else:
                _database(db_dir, path).query_top1_batch(_queries(db_dir[1], db_dir[2], rng))
    profiling.disable()
    recs = profiling.records()
    events = {}
    for e in prof.profiler.kineto_results.events():
        events.setdefault(e.name(), []).append(e.start_ns())
    assert recs
    gaps = [min(abs(r.start_ns - s) for s in events[r.name]) for r in recs]
    # the two stamps are microseconds apart: a pause of the host between
    # them shows as a rare outlier, a clock of another origin or unit as
    # seconds or more
    assert np.percentile(gaps, 90) <= 1_000_000, gaps
    assert max(gaps) <= 1_000_000_000, gaps


def test_thread_id_is_read_once_a_thread(monkeypatch):
    """``threading.get_native_id`` is a system call, microseconds on some
    hosts: a span reads the thread's id once, not on every call."""
    profiling.enable()
    with profiling.span("first"):
        pass
    calls = []
    real = threading.get_native_id
    monkeypatch.setattr(threading, "get_native_id", lambda: calls.append(1) or real())
    for _ in range(50):
        with profiling.span("again"):
            pass
    assert calls == []
    assert {r.thread for r in profiling.records()} == {real()}
