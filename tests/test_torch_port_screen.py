"""The port's screened engine against the JAX package's (index/screen.py).

The same numpy inputs, made from a seed, go through
``pfann_tpu.index.screen`` (impl "xla", backend "exact", as
tests/test_screen.py runs it; one case through the Pallas kernel in
interpret mode) and through ``pfann_tpu_torch.index.screen`` on the CPU,
where ``alignment_core`` runs the align-reduce kernel's plain version.

Tolerances:
  * host helpers (layout, pooled copy, int8 quantizers): array-equal.
  * int8 stage 1: the coarse scores are integers (f32 holds them exactly
    at these sizes), so JAX's and the port's are equal given the same
    quantized filters; the collapsed filters are equal too (both add the
    k windows in order in f32).  Candidates are equal, in the same order,
    also where duplicated songs tie.
  * f32 tables: mean scores within 1e-5 (f32 sums of S*d products in other
    orders); offsets equal.
  * bf16 tables: mean scores within 0.004 (0.004*S on sums): JAX rounds
    each window score to bf16 in stage 2, the port sums the bf16 products
    in f32.  Offsets and top-1 songs are compared at each query's winner.
    The f32/bf16 coarse stages differ in the last bits, so a survivor near
    the top-M cut may differ: tables are compared where both hold a song.
  * the int8 exact stage: dequantized scores equal (the window sums are
    exact integers in f32 in both), but within 1 ulp (rtol 1e-6) on rows
    the rescue rescored: JAX multiplies by the two scales inside one jitted
    program, where XLA may fuse the products in another order.  Winner
    scores come from the same f32 host rescore and are equal.
"""

import numpy as np
import pytest
import torch

import jax.experimental.pallas as pl
import jax.numpy as jnp

import pfann_tpu.index.pallas_align as pa
from pfann_tpu.index import align as jalign
from pfann_tpu.index import screen as jscreen
from pfann_tpu.index.database import Database as JaxDatabase
from pfann_tpu_torch.index import align as talign
from pfann_tpu_torch.index import screen as tscreen
from pfann_tpu_torch.index.align_kernel import align_reduce
from pfann_tpu_torch.index.database import Database as TorchDatabase
from tests.test_screen import _capture_mp_logs, make_db, noisy_queries
from tests.test_torch_port_align import _queries, _write_db

JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _engines(emb, counts, dtype=torch.float32, **kw):
    """(JAX engine, port engine) with the same settings."""
    j = jscreen.ScreenedAlignmentEngine(
        emb, counts, score_dtype=JDT[dtype], impl="xla", backend="exact", **kw)
    t = tscreen.ScreenedAlignmentEngine(
        emb, counts, score_dtype=dtype, device="cpu", backend="exact", **kw)
    return j, t


class _Logs:
    """Collects the package logger's records (the multiprocessing logger)."""

    def __enter__(self):
        self.records, self._h, self._logger, self._level = _capture_mp_logs()
        self._logger.addHandler(self._h)
        return self

    def __exit__(self, *exc):
        self._logger.removeHandler(self._h)
        self._logger.setLevel(self._level)

    def lines(self, text, level=None):
        return [r.getMessage() for r in self.records if text in r.getMessage()
                and (level is None or r.levelname == level)]


# ------------------------------------------------------------ host helpers
@pytest.mark.parametrize("pad,k,n_songs", [(16, 4, 13), (32, 8, 8), (8, 4, 1)])
def test_layout_and_quantizers_match_jax(pad, k, n_songs):
    rng = np.random.default_rng(pad + k)
    emb, counts, _ = make_db(rng, n_songs=n_songs, min_len=5, max_len=40, d=16)
    assert tscreen.screen_geometry(int(counts.max()), n_songs, pad, k) == \
        jscreen.screen_geometry(int(counts.max()), n_songs, pad, k)
    tl = tscreen.build_screen_layout(emb, counts, pad=pad, k=k, d=16)
    jl = jscreen.build_screen_layout(emb, counts, pad=pad, k=k, d=16)
    assert tl[2:] == jl[2:]  # R, Rc, n_pad
    np.testing.assert_array_equal(tl[0], jl[0])
    np.testing.assert_array_equal(tl[1], jl[1])
    np.testing.assert_array_equal(tscreen.quantize_coarse_int8(tl[1].copy()),
                                  jscreen.quantize_coarse_int8(jl[1].copy()))

    q = rng.standard_normal((5, 3, 16)).astype(np.float32)
    q[1] *= 1e-3
    q[2] = 0.0  # an all-zero filter: scale 0, values 0
    tq, ts = tscreen.quantize_queries_int8_scaled(torch.from_numpy(q))
    jq, js = jscreen.quantize_queries_int8_scaled(jnp.asarray(q))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tscreen.quantize_queries_int8(torch.from_numpy(q)).numpy(), np.asarray(jq))


def test_pool_k_must_divide_pad_and_dtype_names():
    with pytest.raises(ValueError, match="screen_pool_k"):
        tscreen.screen_geometry(100, 10, 32, 3)
    assert tscreen.coarse_dtype_of("int8", torch.float32) == torch.int8
    assert tscreen.coarse_dtype_of(None, torch.bfloat16) == torch.bfloat16
    assert tscreen.coarse_dtype_of("f32", torch.bfloat16) == torch.float32
    with pytest.raises(ValueError, match="coarse dtype"):
        tscreen.coarse_dtype_of("int4", torch.float32)


# ------------------------------------------------------------- stage 1
def _jax_coarse_scores(coarse_j, qpad, k, Rc, n_pad):
    """JAX's stage 1 (pfann_tpu/index/screen.py:253-265) on its XLA path."""
    S = qpad.shape[1]
    Sc = -(-S // k)
    qc = jnp.pad(jnp.asarray(qpad), ((0, 0), (0, Sc * k - S), (0, 0)))
    qc = qc.reshape(qpad.shape[0], Sc, k, -1).sum(axis=2)
    qc = jscreen.quantize_queries_int8(qc)
    best_c, _ = jalign.alignment_core(
        coarse_j, qc, R=Rc, S=Sc, n_songs=n_pad, score_dtype=jnp.int32, impl="xla")
    return np.asarray(best_c), np.asarray(qc)


def _duplicated_db(rng, n_distinct=12, copies=3, d=32):
    emb, counts, _ = make_db(rng, n_songs=n_distinct, min_len=16, max_len=30, d=d)
    pos = np.pad(np.cumsum(counts), (1, 0))
    order = np.tile(np.arange(n_distinct), copies)  # song j copies j % n
    emb = np.concatenate([emb[pos[s]:pos[s + 1]] for s in order])
    counts = counts[order]
    return emb, counts, np.pad(np.cumsum(counts), (1, 0))


@pytest.mark.parametrize("dup", [False, True])
def test_stage1_int8_scores_and_candidates_match_jax(dup):
    """The int8 coarse scores equal JAX's; the top-M candidates are the same
    songs in the same order, also where duplicated songs tie exactly."""
    rng = np.random.default_rng(30 + dup)
    if dup:
        emb, counts, pos = _duplicated_db(rng)
    else:
        emb, counts, pos = make_db(rng, n_songs=40, min_len=16, d=32)
    pad, k, S, M = 16, 4, 11, 7
    filters, _, _ = noisy_queries(rng, emb, counts, pos, n=10, S=S, noise=0.3)
    filters[3] = filters[2]  # a repeated query
    _, coarse, _, Rc, n_pad = tscreen.build_screen_layout(emb, counts, pad=pad, k=k,
                                                          d=32)
    c8 = tscreen.quantize_coarse_int8(coarse.copy())
    tb = tscreen.coarse_scores(torch.from_numpy(c8), torch.from_numpy(filters), k=k,
                               Rc=Rc, n_pad=n_pad)
    jb, jqc = _jax_coarse_scores(jnp.asarray(np.pad(c8, ((0, pad // k), (0, 0)))),
                                 filters, k, Rc, n_pad)
    tqc = tscreen.quantize_queries_int8(
        tscreen.collapse_queries(torch.from_numpy(filters), k))
    np.testing.assert_array_equal(tqc.numpy(), jqc)
    np.testing.assert_array_equal(tb.numpy(), jb)
    assert (tb.numpy() == np.round(tb.numpy())).all()

    j, t = _engines(emb, counts, pad=pad, k=k, top_m=M, coarse_dtype="int8")
    (jc, jbest, joff), = j.search_device(filters)
    (tc, tbest, toff), = t.search_device(filters)
    jc = np.asarray(jc)[: len(filters)]
    np.testing.assert_array_equal(tc.numpy(), jc)
    np.testing.assert_allclose(tbest.numpy(), np.asarray(jbest)[: len(filters)],
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(toff.numpy(), np.asarray(joff)[: len(filters)])
    if dup:
        # the copies of the true song tie at the top, lower index first
        n = len(counts) // 3
        for b in range(len(filters)):
            top = tc.numpy()[b, :3]
            assert sorted(top % n) == [top[0] % n] * 3 and list(top) == sorted(top)


@pytest.mark.parametrize("coarse_dtype", [None, "int8"])
def test_candidates_match_pallas_interpret(monkeypatch, coarse_dtype):
    """The TPU coarse stage (the Pallas kernel, interpret mode, the int32
    path for int8) and the port's plain version keep the same survivors
    and give the same tables (test_screen.py's interpret parity case)."""
    orig = pl.pallas_call

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(pa.pl, "pallas_call", interp)
    rng = np.random.default_rng(3)
    emb, counts, pos = make_db(rng, n_songs=16, min_len=10, max_len=24, d=32)
    kw = dict(pad=16, k=4, top_m=4, coarse_dtype=coarse_dtype)
    pls = jscreen.ScreenedAlignmentEngine(
        emb, counts, score_dtype=jnp.float32, impl="pallas", interpret=True,
        backend="exact", **kw)
    pls.max_batch = 128
    t = tscreen.ScreenedAlignmentEngine(emb, counts, score_dtype=torch.float32,
                                        device="cpu", **kw)
    S = 6
    filters, want, _ = noisy_queries(rng, emb, counts, pos, n=4, S=S, noise=0.2)
    lens = np.full(len(filters), S, np.int32)
    ps, pt = pls.search(filters, lens)
    ts, tt = t.search(filters, lens)
    assert list(ts.argmax(1)) == list(ps.argmax(1)) == want
    np.testing.assert_array_equal(ts != 0, ps != 0)
    np.testing.assert_allclose(ts, ps, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tt, pt)


# ---------------------------------------------------------- search tables
@pytest.mark.parametrize("k", [4, 8])
@pytest.mark.parametrize("exact_dtype", [None, "int8"])
@pytest.mark.parametrize("coarse_dtype", [None, "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_search_matches_jax(dtype, coarse_dtype, exact_dtype, k):
    rng = np.random.default_rng(k)
    emb, counts, pos = make_db(rng, n_songs=40, min_len=16, d=64)
    S = 12
    filters, want, want_off = noisy_queries(rng, emb, counts, pos, n=12, S=S,
                                            noise=0.15)
    lens = np.full(len(filters), S, np.int32)
    lens[5] = 9
    filters[5, 9:] = 0.0
    j, t = _engines(emb, counts, dtype, pad=16, k=k, top_m=6,
                    coarse_dtype=coarse_dtype, exact_dtype=exact_dtype,
                    rescue_threshold=0.4)
    js, jt = j.search(filters, lens)
    ts, tt = t.search(filters, lens)
    assert ts.shape == (12, 40) and ts.dtype == tt.dtype == np.float32
    win = ts.argmax(1)
    np.testing.assert_array_equal(win, js.argmax(1))
    np.testing.assert_array_equal(np.delete(win, 5), np.delete(want, 5))
    rows = np.arange(12)
    np.testing.assert_array_equal(tt[rows, win], jt[rows, win])
    f32 = dtype == torch.float32 or exact_dtype == "int8"
    tol = 1e-5 if f32 else 0.004
    both = (ts != 0) & (js != 0)
    assert both.sum() >= 0.8 * (js != 0).sum()
    np.testing.assert_allclose(ts[both], js[both], rtol=0, atol=tol)
    if f32:
        np.testing.assert_array_equal(tt[both], jt[both])
    # the winner's score is exact f32 with the int8 exact stage
    if exact_dtype == "int8":
        np.testing.assert_array_equal(ts[rows, win], js[rows, win])

    song, ssum, toff = t.search_top1(filters, lens)
    jsong, jsum, jtoff = j.search_top1(filters, lens)
    np.testing.assert_array_equal(song, jsong)
    np.testing.assert_array_equal(song, win)
    np.testing.assert_array_equal(toff, jtoff)
    np.testing.assert_allclose(ssum, jsum, rtol=0, atol=tol * S)
    np.testing.assert_allclose(ssum / lens, ts[rows, win], rtol=1e-6)


# ---------------------------------------------------------------- rescue
def test_rescue_matches_jax_and_exhaustive():
    """The winner-drop regime of test_screen_rescue_recovers_exhaustive: the
    port's search and search_top1 equal JAX's search, JAX's fused and
    host-gated search_top1, and both exhaustive engines."""
    rng = np.random.default_rng(12)
    emb, counts, pos = make_db(rng, n_songs=48, min_len=16)
    S = 12
    clean, _, _ = noisy_queries(rng, emb, counts, pos, n=8, S=S, noise=0.1)
    noisy, _, _ = noisy_queries(rng, emb, counts, pos, n=16, S=S, noise=0.46)
    filters = np.concatenate([clean, noisy])
    lens = np.full(len(filters), S, np.int32)
    j, t = _engines(emb, counts, pad=16, k=4, top_m=1, rescue_threshold=0.4)
    tfull = talign.AlignmentEngine(emb, counts, pad=16, score_dtype=torch.float32,
                                   device="cpu")
    fs, ft = tfull.search(filters, lens)
    want = fs.argmax(1)
    jfull = jalign.AlignmentEngine(emb, counts, pad=16, score_dtype=jnp.float32,
                                   impl="xla")
    np.testing.assert_array_equal(want, jfull.search(filters, lens)[0].argmax(1))

    bare = tscreen.ScreenedAlignmentEngine(emb, counts, pad=16, k=4, top_m=1,
                                           score_dtype=torch.float32, device="cpu")
    assert list(bare.search(filters, lens)[0].argmax(1)) != list(want)

    with _Logs() as logs:
        ts, tt = t.search(filters, lens)
    msgs = logs.lines("screen rescue")
    assert len(msgs) == 1 and msgs[0].startswith("screen rescue: ")
    n_esc = int(msgs[0].split("/")[0].split()[-1])
    assert len(noisy) <= n_esc < len(filters)
    js, jt = j.search(filters, lens)
    rows = np.arange(len(filters))
    np.testing.assert_array_equal(ts.argmax(1), want)
    np.testing.assert_array_equal(js.argmax(1), want)
    np.testing.assert_allclose(ts[rows, want], fs[rows, want], rtol=1e-6)
    np.testing.assert_array_equal(tt[rows, want], ft[rows, want])
    np.testing.assert_array_equal(tt[rows, want], jt[rows, want])

    with _Logs() as logs:
        song, best, toff = t.search_top1(filters, lens)
    assert logs.lines("screen top-1 rescue: %d/%d" % (n_esc, len(filters)))
    assert j._fused_ok(S)
    fused = j.search_top1(filters, lens)
    j._fused_ok = lambda S: False
    host = j.search_top1(filters, lens)
    for other in (fused, host):
        np.testing.assert_array_equal(song, other[0])
        np.testing.assert_allclose(best, other[1], rtol=1e-5)
        np.testing.assert_array_equal(toff, other[2])
    np.testing.assert_array_equal(song, want)
    np.testing.assert_allclose(best / S, fs[rows, want], rtol=1e-6)
    np.testing.assert_array_equal(toff, ft[rows, want])

    # the device triples: rescued by default, bare on request
    outs = t.search_top1_device(filters)
    np.testing.assert_array_equal(torch.cat([o[0] for o in outs]).numpy(), want)
    outs = t.search_top1_device(filters, rescued=False)
    bsong = torch.cat([o[0] for o in outs]).numpy()
    np.testing.assert_array_equal(bsong, bare.search_top1(filters)[0])


def test_rescue_top1_device_is_the_exhaustive_top1():
    rng = np.random.default_rng(20)
    emb, counts, pos = make_db(rng, n_songs=20, min_len=16, d=32)
    S = 8
    filters, want, want_off = noisy_queries(rng, emb, counts, pos, n=5, S=S, noise=0.1)
    t = tscreen.ScreenedAlignmentEngine(emb, counts, pad=16, k=4, top_m=2,
                                        score_dtype=torch.float32, device="cpu",
                                        rescue_threshold=0.4)
    q = torch.from_numpy(filters)
    song, score, toff = t.rescue_top1_device(q, torch.full((5,), S))
    full = talign.AlignmentEngine(emb, counts, pad=16, score_dtype=torch.float32,
                                  device="cpu")
    fsong, fscore, ft = full.search_top1(filters)
    assert song.tolist() == list(fsong) == want
    assert toff.tolist() == list(ft) == want_off
    np.testing.assert_allclose(score.numpy(), fscore, rtol=1e-6)


def test_exact_int8_rescue_matches_jax():
    """int8 exact stage + rescue in the winner-drop regime (the int8
    full-layout rescore through the kernel's int32 path): answers, offsets
    and the f32 winner scores equal JAX's."""
    rng = np.random.default_rng(18)
    emb, counts, pos = make_db(rng, n_songs=48, min_len=16)
    S = 12
    noisy, _, _ = noisy_queries(rng, emb, counts, pos, n=12, S=S, noise=0.46)
    lens = np.full(len(noisy), S, np.int32)
    j, t = _engines(emb, counts, pad=16, k=4, top_m=1, exact_dtype="int8",
                    rescue_threshold=0.4)
    assert t._db3.dtype == torch.int8 and t.resident_bytes() == (
        t._db3.numel() + t._coarse.numel() * 4)
    with _Logs() as logs:
        ts, tt = t.search(noisy, lens)
    assert logs.lines("screen rescue")
    js, jt = j.search(noisy, lens)
    np.testing.assert_allclose(ts, js, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(tt, jt)
    song, best, toff = t.search_top1(noisy, lens)
    jsong, jbest, jtoff = j.search_top1(noisy, lens)
    np.testing.assert_array_equal(song, jsong)
    np.testing.assert_array_equal(best, jbest)
    np.testing.assert_array_equal(toff, jtoff)
    w = ts.argmax(1)
    np.testing.assert_array_equal(t._f32_rescore_winners(noisy, lens, song, toff),
                                  j._f32_rescore_winners(noisy, lens, song, toff))
    np.testing.assert_array_equal(best / S, ts[np.arange(12), w])


# ------------------------------------------------------------ score_alpha
def test_score_alpha_matches_jax_on_cpu():
    """test_screen_alpha_matches_align_alpha and test_screen_rescue_alpha_parity
    on the port: stage 2 (every song survives) and the escalated rescue
    apply the exp transform with the align engine's masks."""
    rng = np.random.default_rng(7)
    emb, counts, pos = make_db(rng, n_songs=12, d=32)
    alpha, S = 1.5, 6
    filters, want, _ = noisy_queries(rng, emb, counts, pos, n=4, S=S, noise=0.1)
    lens = np.full(len(filters), S, np.int32)
    filters[1, 4:] = 0.0
    lens[1] = 4
    full = talign.AlignmentEngine(emb, counts, pad=8, score_dtype=torch.float32,
                                  device="cpu", score_alpha=alpha)
    fs, ft = full.search(filters, lens)
    for top_m, rescue in ((64, None), (1, 0.99)):
        j, t = _engines(emb, counts, pad=8, k=4, top_m=top_m, score_alpha=alpha,
                        rescue_threshold=rescue)
        ts, tt = t.search(filters, lens)
        js, jt = j.search(filters, lens)
        np.testing.assert_allclose(ts, fs, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(tt, ft)
        np.testing.assert_array_equal(tt, jt)
        assert list(ts.argmax(1)) == want


def test_score_alpha_limits():
    """The int8 exact stage rejects alpha, as in JAX; an unknown device
    raises; alpha on a float exact stage gives JAX's answers (the CPU and
    CUDA paths are the same torch ops)."""
    rng = np.random.default_rng(19)
    emb, counts, pos = make_db(rng, n_songs=8, d=32)
    with pytest.raises(ValueError, match="screen_exact_dtype"):
        tscreen.ScreenedAlignmentEngine(emb, counts, pad=16, exact_dtype="int8",
                                        score_alpha=1.0, device="cpu")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tscreen.ScreenedAlignmentEngine(emb, counts, pad=16, score_alpha=1.0,
                                        device="meta")
    filters, want, _ = noisy_queries(rng, emb, counts, pos, n=3, S=6, noise=0.1)
    lens = np.full(3, 6, np.int32)
    j, t = _engines(emb, counts, pad=16, k=4, top_m=2, score_alpha=1.0,
                    rescue_threshold=0.4)
    song, best, toff = t.search_top1(filters, lens)
    jsong, jbest, jtoff = j.search_top1(filters, lens)
    assert list(song) == list(jsong) == want
    np.testing.assert_array_equal(toff, jtoff)
    np.testing.assert_allclose(best, jbest, rtol=1e-5)
    db3 = torch.zeros(8, 32, 32, dtype=torch.int8)
    with pytest.raises(NotImplementedError, match="screen_exact_dtype"):
        tscreen.screen_core(db3, torch.zeros(64, 32, dtype=torch.int8),
                            torch.zeros(1, 4, 32), torch.ones(8, dtype=torch.bool),
                            k=4, M=2, score_alpha=1.0)
    assert align_reduce.launches == 0


# -------------------------------------------------------------- telemetry
def test_margin_telemetry_info_and_danger():
    rng = np.random.default_rng(8)
    emb, counts, pos = make_db(rng, n_songs=48, min_len=16)
    t = tscreen.ScreenedAlignmentEngine(emb, counts, pad=16, k=4, top_m=4,
                                        score_dtype=torch.float32, device="cpu")
    S = 12
    lens = np.full(16, S, np.int32)
    good, _, _ = noisy_queries(rng, emb, counts, pos, n=16, S=S, noise=0.12)
    with _Logs() as logs:
        t.search(good, lens)
    assert logs.lines("screen stage-1 margin: winner-vs-cut gap p50")
    assert not logs.lines("danger", "WARNING")
    bad = rng.standard_normal((16, S, emb.shape[1])).astype(np.float32)
    bad /= np.linalg.norm(bad, axis=2, keepdims=True)
    with _Logs() as logs:
        t.search(bad, lens)
    assert logs.lines("screen margin danger zone", "WARNING")


def test_backend_approx_takes_exact_top_m():
    rng = np.random.default_rng(9)
    emb, counts, pos = make_db(rng, n_songs=10, d=32)
    with _Logs() as logs:
        t = tscreen.ScreenedAlignmentEngine(emb, counts, pad=16, top_m=3,
                                            device="cpu", backend="approx")
    assert t.backend == "exact" and logs.lines("approx_max_k")
    with pytest.raises(ValueError, match="backend"):
        tscreen.ScreenedAlignmentEngine(emb, counts, device="cpu", backend="fast")


def test_chunking_changes_nothing(monkeypatch):
    """Several dispatch chunks (the stage-2 byte cap) give the one-chunk
    tables and top-1 answers."""
    rng = np.random.default_rng(10)
    emb, counts, pos = make_db(rng, n_songs=20, min_len=16, d=32)
    S = 8
    filters, _, _ = noisy_queries(rng, emb, counts, pos, n=9, S=S, noise=0.3)
    lens = np.full(9, S, np.int32)
    t = tscreen.ScreenedAlignmentEngine(emb, counts, pad=16, top_m=3, device="cpu",
                                        score_dtype=torch.float32, rescue_threshold=0.5)
    one = t.search(filters, lens), t.search_top1(filters, lens)
    assert t._chunk_for(S) >= 9
    monkeypatch.setattr(t, "STAGE2_BYTES_CAP", 1)
    assert t._chunk_for(S) == 1
    many = t.search(filters, lens), t.search_top1(filters, lens)
    for a, b in zip([*one[0], *one[1]], [*many[0], *many[1]]):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- Database
def _screen_db(tmp_path, rng, n_songs=14, d=32):
    root = str(tmp_path / "db")
    counts = rng.integers(20, 45, size=n_songs)
    emb = _write_db(root, counts, d, rng)
    return root, emb, counts


def test_database_engine_selection(tmp_path):
    rng = np.random.default_rng(40)
    root, _, _ = _screen_db(tmp_path, rng)
    base = {"top_k": 5, "db_dtype": "float32", "backend": "exact"}
    for extra, want in (({}, "align"), ({"engine": "screen"}, "screen"),
                        ({"screen": True}, "screen"), ({"screen": False}, "align")):
        db = TorchDatabase(root, {**base, **extra}, hop_size=0.5, device="cpu")
        assert db.engine == want
        assert isinstance(db._align, tscreen.ScreenedAlignmentEngine) == (want == "screen")
    db = TorchDatabase(root, {**base, "screen": True, "screen_pool_k": 8,
                              "screen_top_m": 3, "screen_coarse_dtype": "int8",
                              "screen_exact_dtype": "int8"}, hop_size=0.5, device="cpu")
    eng = db._align
    assert (eng.k, eng.top_m, eng.backend) == (8, 3, "exact")
    assert eng._coarse.dtype == eng._db3.dtype == torch.int8
    for rescue, tau in ((None, 0.4), (0, None), (False, None), (0.55, 0.55)):
        params = {**base, "screen": True}
        if rescue is not None:
            params["screen_rescue"] = rescue
        db = TorchDatabase(root, params, hop_size=0.5, device="cpu")
        jdb = JaxDatabase(root, params, hop_size=0.5)
        assert db._align._rescue_tau == jdb._align._rescue_tau == tau


def test_database_screen_auto_threshold(tmp_path):
    """screen='auto' keeps the exhaustive engine at 29,999 songs and takes
    the screened one at 30,000, as the JAX package does."""
    rng = np.random.default_rng(6)
    for n_songs, want in ((29_999, "align"), (30_000, "screen")):
        root = str(tmp_path / str(n_songs))
        _write_db(root, np.full(n_songs, 2), 8, rng)
        db = TorchDatabase(root, {"top_k": 5, "db_dtype": "float32",
                                  "backend": "exact"}, hop_size=0.5, device="cpu")
        assert db.engine == want


@pytest.mark.parametrize("db_dtype,fsm,coarse", [("float32", 1, "int8"),
                                                 ("bfloat16", 1, None),
                                                 ("float32", 2, None)])
def test_database_screen_matches_jax(tmp_path, db_dtype, fsm, coarse):
    """query_top1_batch (lens reach the rescue gate) and
    query_embeddings_batch of both packages on one screen DB."""
    rng = np.random.default_rng(41)
    root, emb, counts = _screen_db(tmp_path, rng)
    params = {"top_k": 5, "frame_shift_mul": fsm, "db_dtype": db_dtype,
              "screen": True, "screen_top_m": 4, "screen_coarse_dtype": coarse,
              "backend": "exact"}
    jdb = JaxDatabase(root, params, hop_size=0.5)
    tdb = TorchDatabase(root, params, hop_size=0.5, device="cpu")
    assert jdb.engine == tdb.engine == "screen"
    queries = _queries(rng, emb, counts, 6, fsm, lens=[19, 11, 20, 5])
    noise = rng.standard_normal((14, 32)).astype(np.float32)
    queries.append(noise / np.linalg.norm(noise, axis=1, keepdims=True))
    atol = 1e-5 if db_dtype == "float32" else 0.004

    jfull = jdb.query_embeddings_batch(queries)
    tfull = tdb.query_embeddings_batch(queries)
    for (js, (jid, jt), jtab), (ts, (tid, tt), ttab) in zip(jfull, tfull):
        assert (tid, tt) == (jid, jt)
        assert ts == pytest.approx(js, abs=atol)
        both = (ttab[:, 0] != 0) & (jtab[:, 0] != 0)
        np.testing.assert_allclose(ttab[both, 0], jtab[both, 0], rtol=0, atol=atol)
    jtop = jdb.query_top1_batch(queries)
    with _Logs() as logs:
        ttop = tdb.query_top1_batch(queries)
    assert logs.lines("screen top-1 rescue")  # the noise query escalates
    for (js, (jid, jt)), (ts, (tid, tt)), full in zip(jtop, ttop, tfull):
        assert (tid, tt) == (jid, jt) == full[1]
        assert ts == pytest.approx(js, abs=atol)
        assert ts == pytest.approx(full[0], abs=1e-6)
