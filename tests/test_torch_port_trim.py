"""The single-card top-1 path launches its engine at the batch's longest
filter, not at the bucketed width (``Database._query_top1_batch``).

On the CPU, where the engines run the kernel's plain version: the trimmed
answers (song, time, score) equal the bucketed ones, which the same
Database gives with ``_filters`` made to bucket again, on both engines and
on the screen's forms (a query that escalates to stage 3, the int8 exact
stage, ``frame_shift_mul`` 2 with filters of unequal lengths, queries of
mixed lengths).  The zero window rows past the longest filter add exact
zeros to every sum, and the offsets scanned do not depend on S, so the
answers compare with ``==``.  The sharded branch, ``_filters`` and the
full-table path keep the bucketed width; ``window_rows_trimmed`` counts
the rows left out.  The plans the card takes at the benchmark's d = 64
shapes are checked here too (``tile_plan`` is Python).
"""

import os

import numpy as np
import pytest

from pfann_tpu_torch.index import align_kernel
from pfann_tpu_torch.index.database import Database, write_index_meta
from pfann_tpu_torch.index.screen import ScreenedAlignmentEngine, stage2_chunk
from pfann_tpu_torch.index.search import bucket_windows

D = 16
PAD = 32  # the engines' default layout pad: 19 windows bucket to 24


def _write_db(root, rng, n_songs=30, lo=30, hi=70):
    counts = rng.integers(lo, hi, size=n_songs)
    emb = rng.standard_normal((int(counts.sum()), D)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    emb.tofile(os.path.join(root, "embeddings"))
    counts.astype(np.int32).tofile(os.path.join(root, "landmarkKey"))
    with open(os.path.join(root, "songList.txt"), "w") as f:
        f.writelines("s%d.wav\n" % i for i in range(n_songs))
    write_index_meta(root, d=D)
    return emb, counts


def _queries(rng, emb, counts, lens, n_noise=0, noise=0.1):
    """Noisy crops of the given row counts from random songs, then n_noise
    queries of 19 random rows (they fall under the screen's rescue gate)."""
    pos = np.pad(np.cumsum(counts), (1, 0))
    out = []
    for L in lens:
        s = rng.integers(0, len(counts))
        start = pos[s] + rng.integers(0, max(1, counts[s] - L))
        rows = emb[start : start + L]
        out.append(rows + noise * rng.standard_normal(rows.shape).astype(np.float32))
    out += [rng.standard_normal((19, D)).astype(np.float32) for _ in range(n_noise)]
    return [(q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32) for q in out]


def _trimmed_and_bucketed(db, queries, monkeypatch):
    """(trimmed answers, bucketed answers, the widths the engine got)."""
    widths = []
    search_top1 = db._align.search_top1

    def recorded(filters, *a, **k):
        widths.append(filters.shape[1])
        return search_top1(filters, *a, **k)

    monkeypatch.setattr(db._align, "search_top1", recorded)
    got = db.query_top1_batch(queries)
    filters = Database._filters
    monkeypatch.setattr(db, "_filters", lambda q, bucket=True: filters(db, q))
    want = db.query_top1_batch(queries)
    return got, want, widths


CASES = {  # params, query lengths, noise queries
    "align-bf16": ({}, [19] * 6, 2),
    "align-f32": ({"db_dtype": "float32"}, [19] * 6, 2),
    "align-mixed-lengths": ({}, [19, 12, 7, 16, 3], 1),
    "align-fsm2": ({"frame_shift_mul": 2}, [37, 38, 36, 29], 0),
    "screen-escalates": ({"screen": True}, [19] * 6, 3),
    "screen-f32": ({"screen": True, "db_dtype": "float32"}, [19] * 4, 2),
    "screen-mixed-lengths": ({"screen": True}, [19, 12, 7, 16, 3], 2),
    "screen-fsm2": ({"screen": True, "frame_shift_mul": 2}, [37, 38, 36, 29], 1),
    "screen-int8-exact": ({"screen": True, "screen_exact_dtype": "int8"}, [19] * 5, 2),
    "screen-int8-coarse": ({"screen": True, "screen_coarse_dtype": "int8"}, [19, 11], 2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_trimmed_top1_equals_bucketed(tmp_path, monkeypatch, case):
    params, lens, n_noise = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    emb, counts = _write_db(str(tmp_path), rng)
    db = Database(str(tmp_path), {"top_k": 5, "screen_top_m": 4, **params}, 0.5, "cpu")
    assert db.engine == ("screen" if params.get("screen") else "align")
    queries = _queries(rng, emb, counts, lens, n_noise)
    esc0 = getattr(db._align, "escalated", 0)
    got, want, widths = _trimmed_and_bucketed(db, queries, monkeypatch)
    assert got == want
    fsm = params.get("frame_shift_mul", 1)
    S = max(-(-len(q) // fsm) for q in queries)
    assert widths == [S, bucket_windows(S, PAD)]
    if db.engine == "screen":
        # the same queries escalate in both calls, and some do
        esc = db._align.escalated - esc0
        assert esc % 2 == 0 and esc >= 2 * (n_noise > 0)


@pytest.mark.parametrize("n_rows,fsm,per_filter", [
    (19, 1, 5), (12, 1, 4), (16, 1, 0), (24, 1, 0), (32, 1, 0), (37, 2, 5)])
def test_window_rows_trimmed_counts_the_rows_left_out(tmp_path, n_rows, fsm, per_filter):
    """(bucketed S - the longest filter) x filters a top-1 batch, 0 where the
    lengths fill the bucket; the full-table path adds nothing."""
    rng = np.random.default_rng(n_rows)
    emb, counts = _write_db(str(tmp_path), rng, lo=40, hi=70)
    db = Database(str(tmp_path), {"top_k": 5, "frame_shift_mul": fsm}, 0.5, "cpu")
    queries = _queries(rng, emb, counts, [n_rows] * 7)
    db.query_top1_batch(queries)
    assert db.window_rows_trimmed == per_filter * 7 * fsm
    db.query_top1_batch(queries[:3])
    assert db.window_rows_trimmed == per_filter * 10 * fsm
    db.query_embeddings_batch(queries)
    assert db.window_rows_trimmed == per_filter * 10 * fsm


@pytest.mark.parametrize("screen", [False, True])
def test_sharded_branch_keeps_the_bucketed_width(tmp_path, monkeypatch, screen):
    """The sharded top-1's rescue gate reads sum / S with S the bucketed
    width, as JAX's does: it gets the 24-wide filters, nothing is counted
    as trimmed, and its answers are the single-card engine's."""
    rng = np.random.default_rng(7 + screen)
    emb, counts = _write_db(str(tmp_path), rng)
    params = {"top_k": 5, "screen": screen, "screen_top_m": 4, "sharded": True}
    db = Database(str(tmp_path), params, 0.5, "cpu", devices=["cpu"] * 2)
    assert db._sharded is not None
    widths = []
    real = db._sharded.search_top1_rescued

    def recorded(filters, *a, **k):
        widths.append(filters.shape[1])
        return real(filters, *a, **k)

    monkeypatch.setattr(db._sharded, "search_top1_rescued", recorded)
    queries = _queries(rng, emb, counts, [19] * 5, n_noise=2)
    got = db.query_top1_batch(queries)
    assert widths == [24] and db.window_rows_trimmed == 0
    single = Database(str(tmp_path), {**params, "sharded": False}, 0.5, "cpu")
    want = single.query_top1_batch(queries)
    assert [a for _, a in got] == [a for _, a in want]
    np.testing.assert_allclose([s for s, _ in got], [s for s, _ in want], rtol=0, atol=1e-5)


@pytest.mark.parametrize("lens,fsm", [
    ([19, 19], 1), ([19, 12, 7], 1), ([37, 36], 2), ([32], 1), ([5, 3], 1), ([24, 9], 1)])
def test_filters_keep_the_bucketed_width(tmp_path, lens, fsm):
    """``_filters`` gives every other caller what it gave before: each
    shift's rows q[s::fsm] zero-padded to bucket_windows of the longest;
    ``bucket=False`` the same rows at the longest filter's width."""
    rng = np.random.default_rng(len(lens) * 10 + fsm)
    emb, counts = _write_db(str(tmp_path), rng, lo=40, hi=70)
    db = Database(str(tmp_path), {"top_k": 5, "frame_shift_mul": fsm}, 0.5, "cpu")
    queries = _queries(rng, emb, counts, lens)
    subs = [q[s::fsm] for q in queries for s in range(fsm)]
    S = max(len(x) for x in subs)
    want = np.zeros((len(subs), bucket_windows(S, PAD), D), np.float32)
    for i, x in enumerate(subs):
        want[i, : len(x)] = x
    allf, sub_lens = db._filters(queries)
    np.testing.assert_array_equal(allf, want)
    np.testing.assert_array_equal(sub_lens, [len(x) for x in subs])
    trimmed, trimmed_lens = db._filters(queries, bucket=False)
    np.testing.assert_array_equal(trimmed, want[:, :S])
    np.testing.assert_array_equal(trimmed_lens, sub_lens)


@pytest.mark.parametrize("screen", [False, True])
def test_full_table_path_keeps_the_bucketed_width(tmp_path, monkeypatch, screen):
    """query_embeddings_batch (and so search) still launches at the
    bucketed width."""
    rng = np.random.default_rng(11 + screen)
    emb, counts = _write_db(str(tmp_path), rng)
    db = Database(str(tmp_path), {"top_k": 5, "screen": screen, "screen_top_m": 4}, 0.5,
                  "cpu")
    widths = []
    real = db._align.search

    def recorded(filters, *a, **k):
        widths.append(filters.shape[1])
        return real(filters, *a, **k)

    monkeypatch.setattr(db._align, "search", recorded)
    db.query_embeddings_batch(_queries(rng, emb, counts, [19, 12]))
    assert widths == [24]


@pytest.mark.parametrize("B,S,resident,qs", [
    (1, 19, True, 19), (8, 19, True, 19), (32, 19, True, 19), (51, 19, True, 19),
    (64, 19, True, 19), (51, 24, False, 4), (64, 24, False, 4)])
def test_stage3_plan_at_the_benchmark_shape(B, S, resident, qs):
    """Stage 3 at d = 64 over 100,000 songs (R = 160): at the trimmed S = 19
    the query tile stays resident for every B up to one 64-query tile; at
    the bucketed 24 a 64-query tile streams through a ring of 4."""
    plan = align_kernel.tile_plan(B, S, 64, 2, 160, 100_000)
    assert (plan["resident"], plan["qs"], plan["rowsum"]) == (resident, qs, False)
    assert plan["smem"] <= align_kernel.SMEM_LIMIT


@pytest.mark.parametrize("Sc", [5, 6])
def test_stage1_plan_at_the_benchmark_shape(Sc):
    """Stage 1 of a 256-query batch at d = 64 (Rc = 40): Sc = 5 at the
    trimmed width, 6 at the bucketed; both keep the 128-query tile
    resident."""
    plan = align_kernel.tile_plan(256, Sc, 64, 2, 40, 100_000)
    assert (plan["tn"], plan["resident"], plan["qs"]) == (128, True, Sc)


@pytest.mark.parametrize("S", [19, 24])
def test_one_stage2_chunk_per_batch(S):
    """At the benchmark's screen (top_m 32, R = 160, d = 64, bf16) a batch
    of 256 queries is one dispatch at the trimmed width as at the
    bucketed one."""
    n = stage2_chunk(32, 160, S, 64, 2, ScreenedAlignmentEngine.STAGE2_BYTES_CAP)
    assert n >= 256
