"""The port's topk engine (index/search.py) and the Database paths that use
it, against the JAX package.

The same numpy inputs, made from a seed, go through
``pfann_tpu.index.search`` (jitted, on the CPU) and through
``pfann_tpu_torch.index.search`` on the CPU; then both ``Database``
classes serve one DB directory with ``engine: "topk"`` and through the
long-query fallback of the align and screen engines.  The native C++ core
(``native/seqscore.cpp``, built by the port's ``index/native.py``) is held
to the port's topk engine, as tests/test_native.py holds it to JAX's.

Tolerances:
  * top-k labels equal, equal values listed lower index first (also at the
    k-th value); f32 scores atol 1e-5 (f32 sums of d products in other
    orders).
  * f32 DB: song ids and times exact, scores atol 1e-5.
  * bf16 DB: both score f32 sums of bf16-rounded operands; ids and times
    exact where the top-1 margin is clear, mean scores atol 0.004.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pfann_tpu.index import search as jsearch
from pfann_tpu.index.database import Database as JaxDatabase
from pfann_tpu_torch.index import native as tnative
from pfann_tpu_torch.index import search as tsearch
from pfann_tpu_torch.index.align_kernel import align_reduce
from pfann_tpu_torch.index.database import Database as TorchDatabase
from tests.test_torch_port_align import _queries, _write_db
from tests.test_torch_port_screen import _Logs

JDT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}

_j_topk = jax.jit(jsearch.mips_topk, static_argnames=("k", "backend"))
_j_rerank = jax.jit(jsearch.seq_rerank,
                    static_argnames=("n_songs", "frame_shift_mul", "score_alpha"))


def _db(rng, n_songs=10, d=16, empty=(3,)):
    """Unit rows of n_songs songs (the songs in ``empty`` hold no rows)."""
    counts = rng.integers(8, 30, n_songs)
    counts[list(empty)] = 0
    pos = np.pad(np.cumsum(counts), (1, 0))
    db = rng.standard_normal((pos[-1], d)).astype(np.float32)
    return db / np.linalg.norm(db, axis=1, keepdims=True), counts, pos


def _query(rng, db, pos, song, S, n_true, fsm, noise=0.05):
    """[S, d] f32: n_true rows near song's rows (each repeated fsm times,
    the sub-hop stride), zero rows after; and the valid mask."""
    base = np.repeat(db[pos[song] + 2 : pos[song] + 2 + -(-n_true // fsm)], fsm, 0)
    q = np.zeros((S, db.shape[1]), np.float32)
    q[:n_true] = base[:n_true] + noise * rng.standard_normal((n_true, db.shape[1]))
    valid = np.arange(S) < n_true
    return q, valid


# ------------------------------------------------------------ mips_topk
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mips_topk_matches_jax(dtype):
    rng = np.random.default_rng(1)
    db, _, _ = _db(rng)
    q = rng.standard_normal((9, db.shape[1])).astype(np.float32)
    jdt, tdt = JDT[dtype]
    jv, jl = _j_topk(jnp.asarray(db, jdt), jnp.asarray(q), k=7)
    tv, tl = tsearch.mips_topk(torch.from_numpy(db).to(tdt), torch.from_numpy(q), 7)
    assert tv.dtype == torch.float32 and tl.dtype == torch.int32
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-5)
    # k past N returns every row
    _, tl = tsearch.mips_topk(torch.from_numpy(db[:5]), torch.from_numpy(q), 7)
    assert tl.shape == (9, 5)


@pytest.mark.parametrize("k", [3, 4, 6])
def test_topk_ties_list_lower_index_first(k):
    """Rows 1, 4, 6 and 9 of the DB are one vector: the ties sit inside the
    top-k (k=6), straddle the k-th value (k=3: two of four copies kept,
    the lowest-indexed ones) and end exactly at it (k=4); jax.lax.top_k's
    order in every case."""
    rng = np.random.default_rng(2)
    db = rng.standard_normal((12, 8)).astype(np.float32) * 0.1
    v = np.ones(8, np.float32)
    for r in (9, 4, 1, 6):
        db[r] = v
    db[7] = 2 * v  # one value above the tied ones
    q = np.stack([v, -v, v])
    jv, jl = _j_topk(jnp.asarray(db), jnp.asarray(q), k=k)
    tv, tl = tsearch.mips_topk(torch.from_numpy(db), torch.from_numpy(q), k)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-5)
    assert tl[0, : min(k, 5)].tolist() == [7, 1, 4, 6, 9][: min(k, 5)]


# ------------------------------------------------------------ seq_rerank
@pytest.mark.parametrize("dtype,fsm,alpha", [
    ("float32", 1, 0.0), ("float32", 2, 0.0), ("float32", 1, 1.5),
    ("float32", 2, 1.5), ("bfloat16", 1, 0.0), ("bfloat16", 2, 1.5),
])
def test_search_and_rerank_matches_jax(dtype, fsm, alpha):
    """Padded query rows (valid False) add nothing, also under alpha; songs
    with no candidate keep -inf and time 0."""
    rng = np.random.default_rng(3 + fsm)
    db, counts, pos = _db(rng)
    jdt, tdt = JDT[dtype]
    n_songs = len(counts)
    for song, n_true in ((5, 12), (0, 7), (8, 16)):
        q, valid = _query(rng, db, pos, song, 16, n_true, fsm)
        jm, jt = jsearch.search_and_rerank(
            jnp.asarray(db, jdt), jnp.asarray(pos, jnp.int32), jnp.asarray(q),
            jnp.asarray(valid), top_k=3, n_songs=n_songs, frame_shift_mul=fsm,
            score_alpha=alpha)
        tm, tt = tsearch.search_and_rerank(
            torch.from_numpy(db).to(tdt), torch.from_numpy(pos), torch.from_numpy(q),
            torch.from_numpy(valid), top_k=3, n_songs=n_songs, frame_shift_mul=fsm,
            score_alpha=alpha)
        jm, jt, tm, tt = np.asarray(jm), np.asarray(jt), tm.numpy(), tt.numpy()
        hit = np.isfinite(jm)
        np.testing.assert_array_equal(np.isfinite(tm), hit)
        assert 0 < hit.sum() < n_songs and not hit[3]  # some songs unseen
        np.testing.assert_allclose(tm[hit], jm[hit], rtol=0, atol=1e-5)
        np.testing.assert_array_equal(tt, jt)
        assert (tt[~hit] == 0).all()
        assert tm.argmax() == song


def test_seq_rerank_matches_jax_on_given_labels():
    """The rerank alone, on labels with -1 holes and duplicate hits (a
    duplicate recomputes the same score: the largest candidate wins)."""
    rng = np.random.default_rng(4)
    db, counts, pos = _db(rng)
    q, valid = _query(rng, db, pos, 6, 10, 8, 1)
    labels = rng.integers(0, pos[-1], (10, 4)).astype(np.int32)
    labels[:, 1] = labels[:, 0]
    labels[2, 2] = -1
    labels[~valid] = -1
    for alpha in (0.0, 1.5):
        jm, jt = _j_rerank(jnp.asarray(db), jnp.asarray(pos, jnp.int32), jnp.asarray(q),
                           jnp.asarray(labels), jnp.asarray(valid), n_songs=len(counts),
                           score_alpha=alpha)
        tm, tt = tsearch.seq_rerank(torch.from_numpy(db), torch.from_numpy(pos),
                                    torch.from_numpy(q), torch.from_numpy(labels),
                                    torch.from_numpy(valid), len(counts),
                                    score_alpha=alpha)
        hit = np.isfinite(np.asarray(jm))
        np.testing.assert_allclose(tm.numpy()[hit], np.asarray(jm)[hit], rtol=0, atol=1e-5)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


@pytest.mark.parametrize("dtype,fsm,alpha", [("float32", 1, 0.0), ("bfloat16", 2, 1.5)])
def test_topk_engine_batch_and_chunks(monkeypatch, dtype, fsm, alpha):
    """TopkEngine.search (the batched form) equals search_and_rerank query
    by query, whatever the chunking (one query per chunk under a 1-byte
    cap): times equal, scores within f32 rounding (a batched matmul may
    block its sums otherwise); a zero-length query finds nothing."""
    rng = np.random.default_rng(5)
    db, counts, pos = _db(rng)
    _, tdt = JDT[dtype]
    qs = [_query(rng, db, pos, s, n, n, fsm)[0] for s, n in ((1, 9), (7, 14), (4, 5))]
    qs.append(np.zeros((0, db.shape[1]), np.float32))
    eng = tsearch.TopkEngine(db, pos, top_k=4, frame_shift_mul=fsm, score_alpha=alpha,
                             score_dtype=tdt, device="cpu")
    assert eng._chunk_for(14) >= 4
    sm, st = eng.search(qs)
    for i, q in enumerate(qs[:3]):
        m, t = tsearch.search_and_rerank(
            torch.from_numpy(db).to(tdt), torch.from_numpy(pos), torch.from_numpy(q),
            torch.ones(len(q), dtype=torch.bool), top_k=4, n_songs=len(counts),
            frame_shift_mul=fsm, score_alpha=alpha)
        np.testing.assert_allclose(sm[i], m.numpy(), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(st[i], t.numpy())
    assert np.isneginf(sm[3]).all() and (st[3] == 0).all()
    monkeypatch.setattr(eng, "SCORE_BYTES_CAP", 1)
    assert eng._chunk_for(14) == 1
    sm1, st1 = eng.search(qs)
    np.testing.assert_allclose(sm1, sm, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(st1, st)


# ------------------------------------------------------------ Database
def _compare(tdb, jdb, queries, atol):
    """query_embeddings_batch, query_top1_batch and query_embeddings of
    both packages: ids and times equal where the margin is clear, scores
    within atol."""
    tfull = tdb.query_embeddings_batch(queries)
    jfull = jdb.query_embeddings_batch(queries)
    for (ts, ta, ttab), (js, ja, jtab) in zip(tfull, jfull):
        top2 = np.sort(jtab[:, 0])[-2:]
        if atol < 1e-4 or top2[1] - top2[0] > 2 * atol:
            assert ta == ja
        assert ts == pytest.approx(js, abs=atol)
        np.testing.assert_allclose(ttab[:, 0], jtab[:, 0], rtol=0, atol=atol)
        on = (ttab[:, 0] > 2 * atol) & (jtab[:, 0] > 2 * atol)
        np.testing.assert_array_equal(ttab[on, 1], jtab[on, 1])
    for (ts, ta), (js, ja), full in zip(tdb.query_top1_batch(queries),
                                        jdb.query_top1_batch(queries), tfull):
        assert ta == full[1]
        assert ts == pytest.approx(js, abs=atol)
    assert tdb.query_embeddings(queries[0])[1] == tfull[0][1]


@pytest.mark.parametrize("db_dtype,fsm,alpha", [
    ("float32", 1, 0.0), ("bfloat16", 1, 0.0), ("float32", 2, 1.5),
])
def test_database_topk_engine_matches_jax(tmp_path, db_dtype, fsm, alpha):
    rng = np.random.default_rng(11)
    counts = rng.integers(25, 70, size=9)
    root = str(tmp_path / "db")
    emb = _write_db(root, counts, 16, rng)
    params = {"top_k": 6, "engine": "topk", "frame_shift_mul": fsm,
              "db_dtype": db_dtype, "score_alpha": alpha}
    tdb = TorchDatabase(root, params, hop_size=0.5, device="cpu")
    jdb = JaxDatabase(root, params, hop_size=0.5)
    assert tdb.engine == "topk" and tdb._topk is not None
    queries = _queries(rng, emb, counts, 6, fsm, lens=[19, 11, 20, 5])
    _compare(tdb, jdb, queries, 1e-5 if db_dtype == "float32" else 0.004)
    assert align_reduce.launches == 0


@pytest.mark.parametrize("engine,db_dtype", [("align", "float32"), ("screen", "float32"),
                                             ("align", "bfloat16")])
def test_long_query_fallback_matches_jax(tmp_path, engine, db_dtype):
    """Queries longer than the layout pad (here 8 windows) are served by the
    topk engine in both packages, with one warning per length; shorter
    queries stay on the fast engine."""
    rng = np.random.default_rng(12)
    counts = rng.integers(25, 50, size=10)
    root = str(tmp_path / "db")
    emb = _write_db(root, counts, 16, rng, meta={"align_pad": 8})
    params = {"top_k": 6, "engine": engine, "db_dtype": db_dtype,
              "screen_top_m": 4, "backend": "exact"}
    tdb = TorchDatabase(root, params, hop_size=0.5, device="cpu")
    jdb = JaxDatabase(root, params, hop_size=0.5)
    assert tdb.engine == engine and tdb._topk is None
    long_q = _queries(rng, emb, counts, 4, 1, lens=[12, 19])
    with _Logs() as logs:
        _compare(tdb, jdb, long_q, 1e-5 if db_dtype == "float32" else 0.004)
    text = "exceeds the %s engine's 8-window layout pad" % engine
    assert len(set(logs.lines(text, "WARNING"))) == 2  # lengths 12 and 19
    assert tdb._topk is not None and tdb._fallback_logged == {12, 19}
    with _Logs() as logs:
        tdb.query_embeddings_batch(long_q)
    assert not logs.lines(text)  # once per length
    short = _queries(rng, emb, counts, 2, 1, lens=[8])
    assert tdb._use_align(8)
    for (ts, ta), (js, ja) in zip(tdb.query_top1_batch(short), jdb.query_top1_batch(short)):
        assert ta == ja


# ------------------------------------------------------------ native core
@pytest.fixture(scope="module")
def native_lib():
    if tnative.shutil.which("g++") is None:
        pytest.skip("no g++ to build the native core")
    return tnative.load()


def test_native_matches_port_topk_engine(native_lib):
    """The native core (f32, host) against the port's topk engine, as
    tests/test_native.py holds it to JAX's."""
    rng = np.random.default_rng(0)
    db, counts, pos = _db(rng, n_songs=8, empty=())
    query = db[pos[3] + 1 : pos[3] + 8].copy()
    query += 0.05 * rng.standard_normal(query.shape).astype(np.float32)
    query /= np.linalg.norm(query, axis=1, keepdims=True)
    for alpha in (0.0, 4.0):
        best, song_scores = tnative.native_query(db, pos, query, top_k=5,
                                                 score_alpha=alpha)
        eng = tsearch.TopkEngine(db, pos, top_k=5, score_alpha=alpha,
                                 score_dtype=torch.float32, device="cpu")
        sm, st = eng.search([query])
        _, (tbest, _), table = tsearch.finalize_song_scores(sm[0], st[0], 1.0, 1)
        assert best == tbest == 3
        np.testing.assert_allclose(song_scores[:, 0], table[:, 0], rtol=1e-4, atol=1e-5)
        rec = table[:, 0] > 0
        np.testing.assert_allclose(song_scores[rec, 1], table[rec, 1], atol=1e-5)


def test_native_build_goes_to_build_dir_and_failures_raise(native_lib, tmp_path,
                                                           monkeypatch):
    """The library and the matcher binary land in pfann_tpu_torch/_build/
    (never native/), keyed by a hash of sources and flags; a compiler
    error raises with the compiler's stderr."""
    from pfann_tpu_torch.index.align_kernel import BUILD_DIR

    for path in (tnative.lib_path(), tnative.matcher_binary()):
        assert os.path.dirname(path) == BUILD_DIR and os.path.exists(path)
    bad = tmp_path / "native"
    bad.mkdir()
    (bad / "seqscore.cpp").write_text("int broken( {\n")
    monkeypatch.setattr(tnative, "NATIVE_DIR", str(bad))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        tnative.lib_path()
    assert "seqscore.cpp" in str(err.value)


def test_native_build_without_openmp_where_the_toolchain_lacks_it(native_lib, tmp_path,
                                                                   monkeypatch):
    """Where g++ cannot link OpenMP (no libgomp), the core builds without
    -fopenmp under its own hash, with a warning; any other failure
    raises."""
    run = tnative.subprocess.run
    seen = []

    def no_libgomp(cmd, **kw):
        seen.append("-fopenmp" in cmd)
        if "-fopenmp" in cmd:
            return tnative.subprocess.CompletedProcess(
                cmd, 1, "", "g++: fatal error: cannot read spec file 'libgomp.spec'\n")
        return run(cmd, **kw)

    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(tnative.subprocess, "run", no_libgomp)
    with _Logs() as logs:
        path = tnative.lib_path()
    assert seen == [True, False] and os.path.exists(path)
    assert os.path.dirname(path) == str(tmp_path)
    assert logs.lines("without -fopenmp", "WARNING")
    assert tnative.lib_path() == path and seen == [True, False, True]
