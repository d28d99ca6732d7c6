"""The port's exhaustive alignment engine against the JAX package.

On the CPU, ``alignment_core`` runs the plain PyTorch version of the
align-reduce kernel; it is held against the JAX Pallas kernel (interpret
mode, as tests/test_pallas_align.py runs it) and the JAX XLA path.

Tolerances:
  * f32: best within atol 1e-4 (both sum S*d f32 products, in different
    orders); argoff exactly equal.
  * bf16 against JAX impl="xla": atol 0.004*S.  The XLA path rounds each
    window's score to bf16 before the diagonal sum (align.py:184-187),
    up to 2^-9 relative on scores of magnitude <= 1 per window; the port
    sums the bf16 products in f32.  Offsets and top-1 ids are compared
    where the margin to the runner-up exceeds that tolerance.

The CUDA kernel itself is tested on the card by test_torch_port_kernel.py.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp

import pfann_tpu.index.pallas_align as pa
from pfann_tpu.index import align as jalign
from pfann_tpu.index.database import Database as JaxDatabase
from pfann_tpu_torch.index import align as talign
from pfann_tpu_torch.index import align_kernel
from pfann_tpu_torch.index.align_kernel import align_reduce
from pfann_tpu_torch.index.database import Database as TorchDatabase
from tests.test_torch_port_kernel import _definition


def _interpret(monkeypatch):
    orig = pl.pallas_call

    def interp(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(pa.pl, "pallas_call", interp)


def _corpus(rng, counts, d):
    emb = rng.standard_normal((int(np.sum(counts)), d)).astype(np.float32)
    return emb / np.linalg.norm(emb, axis=1, keepdims=True)


def _port(db, qs, R, S, n_songs, dtype=torch.float32):
    best, off = talign.alignment_core(
        torch.from_numpy(db).to(dtype), torch.from_numpy(qs).to(dtype),
        R=R, S=S, n_songs=n_songs,
    )
    assert best.dtype == torch.float32 and off.dtype == torch.int32
    return best.numpy(), off.numpy()


@pytest.mark.parametrize("S", [7, 32])
def test_alignment_core_matches_pallas_interpret(monkeypatch, S):
    """Plain version == the TPU kernel (interpret mode) on the Pallas
    layout: f32, B=128, pad 32."""
    _interpret(monkeypatch)
    rng = np.random.default_rng(S)
    d, pad, B = 32, 32, 128
    counts = np.asarray([20, 5, 33, 12, 9])
    emb = _corpus(rng, counts, d)
    db, R = jalign.build_uniform_layout(
        emb, counts, pad=pad, round_r_to=8, pad_songs_to=pa.PALLAS_G,
        trailing_pad=False,
    )
    qs = (rng.standard_normal((B, S, d)) * 0.2).astype(np.float32)
    jb, jo = jalign.alignment_core(
        jnp.asarray(db), jnp.asarray(qs), R=R, S=S, n_songs=len(counts),
        impl="pallas", score_dtype=jnp.float32,
    )
    tb, to = _port(db, qs, R, S, len(counts))
    np.testing.assert_allclose(tb, np.asarray(jb), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(to, np.asarray(jo))


@pytest.mark.parametrize("case", ["pad32_S19_B13", "pad48_S41_B24", "pad128_S119_B5"])
def test_alignment_core_f32_matches_xla(case):
    """Any S <= pad and any B (the TPU kernel's HALO=32 and B%128 limits do
    not carry over): f32 against JAX impl='xla' on the port's layout."""
    pad, S, B = (int(p[3:] if i == 0 else p[1:]) for i, p in enumerate(case.split("_")))
    rng = np.random.default_rng(pad + S)
    d = 16
    counts = np.asarray([50, 44, 61, 7])
    emb = _corpus(rng, counts, d)
    db, R = talign.build_uniform_layout(emb, counts, pad=pad)
    qs = (rng.standard_normal((B, S, d)) * 0.3).astype(np.float32)
    jb, jo = jalign.alignment_core(
        jnp.asarray(db), jnp.asarray(qs), R=R, S=S, n_songs=len(counts),
        impl="xla", score_dtype=jnp.float32,
    )
    tb, to = _port(db, qs, R, S, len(counts))
    assert tb.shape == (B, len(counts))
    np.testing.assert_allclose(tb, np.asarray(jb), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(to, np.asarray(jo))


def test_alignment_core_bf16_matches_xla():
    """bf16 db and queries against JAX impl='xla' (bf16 window scores):
    scores within 0.004*S; per-song offsets and top-1 songs equal wherever
    the margin to the runner-up exceeds that."""
    rng = np.random.default_rng(3)
    d, pad, S, B = 32, 32, 19, 37
    counts = rng.integers(20, 60, size=12)
    emb = _corpus(rng, counts, d)
    db, R = talign.build_uniform_layout(emb, counts, pad=pad)
    # noisy self-queries: windows of the DB itself, so top-1 margins are real
    song = rng.integers(0, len(counts), size=B)
    qs = np.zeros((B, S, d), np.float32)
    for b in range(B):
        start = song[b] * R + pad + rng.integers(0, counts[song[b]] - S + 1)
        qs[b] = db[start : start + S] + 0.1 * rng.standard_normal((S, d))
    qs /= np.linalg.norm(qs, axis=2, keepdims=True)
    tol = 0.004 * S

    jb, jo = jalign.alignment_core(
        jnp.asarray(db, jnp.bfloat16), jnp.asarray(qs, jnp.bfloat16), R=R, S=S,
        n_songs=len(counts), impl="xla", score_dtype=jnp.bfloat16,
    )
    jb, jo = np.asarray(jb), np.asarray(jo)
    tb, to = _port(db, qs, R, S, len(counts), torch.bfloat16)
    np.testing.assert_allclose(tb, jb, rtol=0, atol=tol)

    exact = _definition(db, qs, R, S, len(counts))
    top2 = np.sort(exact, axis=2)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 2 * tol
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(to[clear], jo[clear])
    song_top2 = np.sort(tb, axis=1)[:, -2:]
    sure = song_top2[:, 1] - song_top2[:, 0] > 2 * tol
    assert sure.all()
    np.testing.assert_array_equal(tb.argmax(1), jb.argmax(1))
    np.testing.assert_array_equal(tb.argmax(1), song)


def test_ties_take_last_offset_and_first_song():
    """Duplicate rows make several offsets score exactly equal: argoff is
    the LARGEST (pallas_align.py:73-75); an all-zero query scores 0
    everywhere (argoff R-1); _top1 takes the FIRST best song."""
    d, pad = 8, 4
    v = np.zeros(d, np.float32)
    v[0] = 1.0
    emb = np.stack([v] * 6 + [v] * 6)  # two identical songs
    counts = np.asarray([6, 6])
    db, R = talign.build_uniform_layout(emb, counts, pad=pad)
    qs = np.zeros((2, 2, d), np.float32)
    qs[0, 0] = v  # S=2 filter [v, 0]: score 1 at every song row
    tb, to = _port(db, qs, R, 2, 2)
    jb, jo = jalign.alignment_core(
        jnp.asarray(db), jnp.asarray(qs), R=R, S=2, n_songs=2, impl="xla",
        score_dtype=jnp.float32,
    )
    np.testing.assert_array_equal(tb, np.asarray(jb))
    np.testing.assert_array_equal(to, np.asarray(jo))
    assert (to[0] == pad + 5).all() and (tb[0] == 1.0).all()
    assert (to[1] == R - 1).all() and (tb[1] == 0.0).all()
    song, score, t = talign._top1(torch.from_numpy(tb), torch.from_numpy(to), pad)
    assert song.tolist() == [0, 0] and t.tolist() == [5.0, R - 1 - pad]


def test_queries_to_filters_fsm2_matches_jax():
    rng = np.random.default_rng(0)
    q = rng.standard_normal((9, 4)).astype(np.float32)
    for fsm, max_w in ((1, 32), (2, 32), (3, 2)):
        got = talign.queries_to_filters(q, fsm, max_w)
        want = jalign.queries_to_filters(q, fsm, max_w)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def _alpha_case():
    """A small score_alpha problem and JAX's f32 XLA answer to it."""
    rng = np.random.default_rng(4)
    d, pad, S, B = 16, 8, 6, 5
    counts = np.asarray([10, 3, 14])
    emb = _corpus(rng, counts, d)
    db, R = talign.build_uniform_layout(emb, counts, pad=pad)
    rv = talign.build_row_valid(counts, R, pad, db.shape[0])
    np.testing.assert_array_equal(rv, jalign.build_row_valid(counts, R, pad, db.shape[0]))
    qs = (rng.standard_normal((B, S, d)) * 0.3).astype(np.float32)
    qv = (np.arange(S)[:, None] < np.asarray([6, 4, 6, 1, 3])[None]).astype(np.float32)
    qs = qs * qv.T[:, :, None]
    jb, jo = jalign.alignment_core(
        jnp.asarray(db), jnp.asarray(qs), R=R, S=S, n_songs=3, impl="xla",
        score_dtype=jnp.float32, score_alpha=2.0, row_valid=jnp.asarray(rv),
        q_valid=jnp.asarray(qv),
    )
    port = dict(db=torch.from_numpy(db), queries=torch.from_numpy(qs), R=R, S=S,
                n_songs=3, score_alpha=2.0, row_valid=torch.from_numpy(rv),
                q_valid=torch.from_numpy(qv))
    return port, np.asarray(jb), np.asarray(jo)


def test_score_alpha_cpu_matches_xla():
    """score_alpha != 0 runs the plain CPU path (exp(-alpha (1-ip)^2) per
    window, masked off-song and off-query), equal to JAX's f32 XLA path."""
    port, jb, jo = _alpha_case()
    tb, to = talign.alignment_core(**port)
    np.testing.assert_allclose(tb.numpy(), jb, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(to.numpy(), jo)


def test_score_alpha_chunks_queries(monkeypatch):
    """The alpha path shares the plain version's bounded chunks over B: one
    query per chunk gives JAX's answer too (q_valid follows the chunk)."""
    monkeypatch.setattr(align_kernel, "REFERENCE_SCORE_BYTES", 1)
    port, jb, jo = _alpha_case()
    tb, to = talign.alignment_core(**port)
    np.testing.assert_allclose(tb.numpy(), jb, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(to.numpy(), jo)


def test_wrapper_rejects_non_cpu_non_cuda(monkeypatch):
    """The wrapper takes the plain version only for CPU tensors; anything
    else either launches the kernel (CUDA) or raises.  The alpha path runs
    as torch ops on the CPU and CUDA alike, never through the kernel: it
    gives JAX's answer, and an unknown device raises."""
    db = torch.empty(10, 4, device="meta")
    q = torch.empty(2, 3, 4, device="meta")
    with pytest.raises(ValueError):
        align_reduce(db, q, 5, 3, 2)
    with pytest.raises(ValueError, match="cuda or cpu"):
        talign.alignment_core(db, q, R=5, S=3, n_songs=2, score_alpha=1.0)

    def no_kernel(*a, **k):
        raise AssertionError("the alpha path reached align_reduce")

    monkeypatch.setattr(talign, "align_reduce", no_kernel)
    port, jb, jo = _alpha_case()
    tb, to = talign.alignment_core(**port)
    np.testing.assert_allclose(tb.numpy(), jb, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(to.numpy(), jo)
    assert align_reduce.launches == 0


# ----------------------------------------------------------- Database level
def _write_db(root, counts, d, rng, meta=None):
    os.makedirs(root, exist_ok=True)
    emb = _corpus(rng, counts, d)
    emb.tofile(os.path.join(root, "embeddings"))
    np.asarray(counts, np.int32).tofile(os.path.join(root, "landmarkKey"))
    with open(os.path.join(root, "songList.txt"), "w") as f:
        f.writelines("song%d.wav\n" % i for i in range(len(counts)))
    m = {"version": 1, "metric": "inner_product", "d": d, "ntotal": int(sum(counts))}
    m.update(meta or {})
    with open(os.path.join(root, "index_meta.json"), "w") as f:
        json.dump(m, f)
    return emb


def _queries(rng, emb, counts, n, fsm, lens):
    pos = np.pad(np.cumsum(counts), (1, 0))
    out = []
    for j in range(n):
        s = rng.integers(0, len(counts))
        L = lens[j % len(lens)]
        start = pos[s] + rng.integers(0, counts[s] - L // fsm)
        rows = np.repeat(emb[start : start + -(-L // fsm)], fsm, axis=0)[:L]
        q = rows + 0.05 * rng.standard_normal(rows.shape)
        out.append((q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32))
    return out


@pytest.mark.parametrize("db_dtype,fsm", [("float32", 1), ("bfloat16", 1), ("float32", 2)])
def test_database_matches_jax(tmp_path, db_dtype, fsm):
    """query_embeddings_batch / query_top1_batch / query_embeddings of both
    packages on one DB directory: equal songs and times, scores within
    tolerance (f32 1e-5; bf16 0.004 on mean scores)."""
    rng = np.random.default_rng(11)
    counts = rng.integers(25, 70, size=9)
    d = 16
    root = str(tmp_path / "db")
    emb = _write_db(root, counts, d, rng)
    params = {"top_k": 10, "frame_shift_mul": fsm, "db_dtype": db_dtype}
    jdb = JaxDatabase(root, params, hop_size=0.5)
    tdb = TorchDatabase(root, params, hop_size=0.5, device="cpu")
    queries = _queries(rng, emb, counts, 7, fsm, lens=[19, 11, 20, 5])
    atol = 1e-5 if db_dtype == "float32" else 0.004

    jfull = jdb.query_embeddings_batch(queries)
    tfull = tdb.query_embeddings_batch(queries)
    for (js, (jid, jt), jtab), (ts, (tid, tt), ttab) in zip(jfull, tfull):
        assert tid == jid and tt == jt
        assert ts == pytest.approx(js, abs=atol)
        np.testing.assert_allclose(ttab[:, 0], jtab[:, 0], rtol=0, atol=atol)
        on = (ttab[:, 0] > 2 * atol) & (jtab[:, 0] > 2 * atol)
        np.testing.assert_array_equal(ttab[on, 1], jtab[on, 1])

    jtop = jdb.query_top1_batch(queries)
    ttop = tdb.query_top1_batch(queries)
    for (js, (jid, jt)), (ts, (tid, tt)), full in zip(jtop, ttop, tfull):
        assert (tid, tt) == (jid, jt) == full[1]
        assert ts == pytest.approx(js, abs=atol)
        assert ts == pytest.approx(full[0], abs=1e-6)

    one = tdb.query_embeddings(queries[0])
    assert one[1] == tfull[0][1]


def test_database_align_pad_from_meta_and_limits(tmp_path):
    """align_pad comes from index_meta.json; a query longer than the pad and
    the topk engine give JAX's answers (the topk fallback); only the
    sharded engine raises NotImplementedError, and an unknown device or
    engine ValueError; the screened engine is served."""
    rng = np.random.default_rng(2)
    counts = np.asarray([60, 70])
    root = str(tmp_path / "db")
    emb = _write_db(root, counts, 8, rng, meta={"align_pad": 48})
    tdb = TorchDatabase(root, {"top_k": 5}, hop_size=0.5, device="cpu")
    jdb = JaxDatabase(root, {"top_k": 5}, hop_size=0.5)
    assert tdb._align.pad == jdb._align.pad == 48
    q = _queries(rng, emb, counts, 1, 1, lens=[41])
    (ts, (tid, tt)), = tdb.query_top1_batch(q)
    (js, (jid, jt)), = jdb.query_top1_batch(q)
    assert (tid, tt) == (jid, jt)
    long_q = _queries(rng, emb, counts, 2, 1, lens=[49, 55])
    topk_db = TorchDatabase(root, {"top_k": 5, "engine": "topk"}, hop_size=0.5,
                            device="cpu")
    jtopk_db = JaxDatabase(root, {"top_k": 5, "engine": "topk"}, hop_size=0.5)
    for t, j in ((tdb, jdb), (topk_db, jtopk_db)):
        for (ls, la), (ljs, lja) in zip(t.query_top1_batch(long_q),
                                        j.query_top1_batch(long_q)):
            assert la == lja
            assert ls == pytest.approx(ljs, abs=0.004)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TorchDatabase(root, {"sharded": True, "top_k": 5}, hop_size=0.5, device="cpu")
    with pytest.raises(ValueError, match="cuda or cpu"):
        TorchDatabase(root, {"top_k": 5}, hop_size=0.5, device="meta")
    with pytest.raises(ValueError, match="engine"):
        TorchDatabase(root, {"top_k": 5, "engine": "faiss"}, hop_size=0.5, device="cpu")
    for screen in ({"engine": "screen"}, {"screen": True}):
        sdb = TorchDatabase(root, dict(screen, top_k=5), hop_size=0.5, device="cpu")
        assert sdb.engine == "screen" and sdb._align.pad == 48
        assert sdb.query_top1_batch(q)[0][1] == (tid, tt)
