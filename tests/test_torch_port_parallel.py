"""The port's multi-device paths against the JAX package's, on the CPU.

Serving: ``pfann_tpu_torch.parallel.ShardedDatabase`` on ``[cpu] * n``
against ``pfann_tpu.parallel.ShardedDatabase`` on n of tests/conftest.py's
8 CPU devices (``impl="xla"``), one test for each of tests/test_parallel.py:
song ids, offsets and flat indices equal, f32 scores within 1e-5; bf16 by
ROADMAP §3 item 3's margin rule (JAX's XLA path rounds each window score to
bf16).  ``Database`` with ``sharded: true`` and ``devices=[cpu] * 8``
against the JAX ``Database`` sharded over the 8 devices.

Training: the data-parallel step as 2 gloo ranks (processes) against the
JAX step on the 8-device mesh and the port's one-process step (loss rtol
1e-5, grads rtol 3e-3 atol 1e-4, JAX's tolerances), and the ``--dp`` CLI.

``utils/profiling.py``: the trace file, a span's range in it and its
summary (the span tracer itself: tests/test_torch_port_tracing.py).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pfann_tpu_torch.index.align import AlignmentEngine
from pfann_tpu_torch.index.database import Database, write_index_meta
from pfann_tpu_torch.parallel import ShardedDatabase, local_devices
from pfann_tpu_torch.parallel import sharded_search as tss

# The JAX side is imported inside the tests: a spawned data-parallel rank
# imports this module for its entry point and needs none of it.
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
# bf16: ids and offsets compared where the top-1 mean score clears the
# runner-up by this much (JAX's XLA path rounds window scores to bf16)
BF16_MARGIN = 0.01


@pytest.fixture(autouse=True)
def _few_threads(monkeypatch):
    """Two torch threads here and in child processes (several test workers
    share the machine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    yield
    torch.set_num_threads(n)


def make_db(rng, n_songs=12, min_len=5, max_len=40, d=16):
    counts = rng.integers(min_len, max_len, n_songs)
    song_pos = np.pad(np.cumsum(counts.astype(np.int64)), (1, 0))
    db = rng.standard_normal((song_pos[-1], d)).astype(np.float32)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    return db, counts, song_pos


def noisy_queries(rng, db, counts, song_pos, n, S, noise=lambda b: 0.1):
    qs, want = [], []
    for b in range(n):
        song = int(rng.integers(0, len(counts)))
        off = int(rng.integers(0, counts[song] - S))
        q = db[song_pos[song] + off : song_pos[song] + off + S].copy()
        q += noise(b) * rng.standard_normal(q.shape).astype(np.float32)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        qs.append(q)
        want.append(song)
    return qs, want


def pair(db, counts, n, dtype="float32", **kw):
    """The JAX and the port's sharded DBs over n devices."""
    import jax.numpy as jnp
    from pfann_tpu.parallel import sharded_search as jss
    from pfann_tpu.parallel.mesh import make_mesh

    j = jss.ShardedDatabase(db, counts, make_mesh("db", n), impl="xla",
                            db_dtype=getattr(jnp, dtype), **kw)
    t = ShardedDatabase(db, counts, [CPU] * n, db_dtype=getattr(torch, dtype), **kw)
    return j, t


def assert_tables_equal(j, t, qs, rtol=1e-5):
    jm, jt = j.query_batch(qs)
    tm, tt = t.query_batch(qs)
    np.testing.assert_array_equal(np.isfinite(tm), np.isfinite(jm))
    np.testing.assert_allclose(tm, jm, rtol=rtol, atol=1e-6)
    np.testing.assert_array_equal(tt, jt)
    return tm, tt


def assert_top1_equal(j, t, qs, rescued=True):
    import jax.numpy as jnp

    qpad = np.stack(qs).astype(np.float32)
    if rescued:
        jv, ji, jo = j.search_top1_rescued(jnp.asarray(qpad))
        tv, ti, to = t.search_top1_rescued(qpad)
    else:
        jv, ji, jo = (np.asarray(x) for x in j.search_top1_device(jnp.asarray(qpad),
                                                                  rescued=False))
        tv, ti, to = (x.numpy() for x in t.search_top1_device(qpad, rescued=False))
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_allclose(tv, jv, rtol=1e-5)
    np.testing.assert_array_equal(t.flat_to_song(ti), j.flat_to_song(ji))
    return t.flat_to_song(ti), tv, to


# ------------------------------------------------------------ partition
def test_partition_songs_balanced_and_equal_to_jax():
    from pfann_tpu.parallel import sharded_search as jss

    counts = np.array([100, 1, 1, 1, 50, 50, 30, 70])
    groups = tss.partition_songs(counts, 4)
    assert sorted(sum(groups, [])) == list(range(8))
    loads = [sum(counts[g]) for g in groups]
    assert max(loads) - min(loads) <= 100
    rng = np.random.default_rng(3)
    db, counts, song_pos = make_db(rng, n_songs=40, d=8)
    for n in (1, 3, 8, 64):
        groups = tss.partition_songs(counts, n)
        assert groups == jss.partition_songs(counts, n)
        for g in groups:
            rows, c = tss.gather_shard_rows(db, song_pos, counts, g, 8)
            want = jss.gather_shard_rows(db, song_pos, counts, g, 8)
            np.testing.assert_array_equal(rows, want[0])
            np.testing.assert_array_equal(c, want[1])


def test_local_devices():
    assert local_devices(8, "cpu") == [CPU] * 8
    assert local_devices(device="cpu") == [CPU]
    with pytest.raises(ValueError, match="cuda or cpu"):
        local_devices(2, "meta")


# ------------------------------------------------------------ topk engine
@pytest.mark.parametrize("n_dev,top_k", [(2, None), (8, None), (4, 5), (8, 8)])
def test_topk_engine_matches_jax(n_dev, top_k):
    """Per-shard top-k + rerank: the tables equal JAX's sharded ones (with
    top_k >= a shard's rows, also the unsharded engine's; with a small
    top_k the candidates are a per-shard superset, as in JAX)."""
    rng = np.random.default_rng(0 if top_k is None else 1)
    db, counts, song_pos = make_db(rng, n_songs=16)
    top_k = int(counts.sum()) if top_k is None else top_k
    j, t = pair(db, counts, n_dev, top_k=top_k, backend="exact")
    qs = [db[song_pos[s] + 1 : song_pos[s] + 1 + L]
          + 0.02 * rng.standard_normal((L, 16)).astype(np.float32)
          for s, L in ((5, 7), (0, 4), (15, 9))]
    tm, _ = assert_tables_equal(j, t, qs)
    assert [int(np.argmax(r)) for r in tm] == [5, 0, 15]


# ------------------------------------------------------------ align engine
@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_align_engine_matches_jax_and_single_device(n_dev):
    rng = np.random.default_rng(5)
    db, counts, song_pos = make_db(rng, n_songs=12, min_len=8)
    j, t = pair(db, counts, n_dev, engine="align", align_pad=16)
    qs, want = noisy_queries(rng, db, counts, song_pos, 5, 6, noise=lambda b: 0.03)
    tm, tt = assert_tables_equal(j, t, qs)
    songs, val, off = assert_top1_equal(j, t, qs)
    assert songs.tolist() == want
    single = AlignmentEngine(db, counts, pad=16, score_dtype=torch.float32, device=CPU)
    ss, st = single.search(np.stack(qs), np.full(len(qs), 6))
    np.testing.assert_allclose(tm, ss, rtol=1e-5, atol=1e-6)
    pos = ss > 1e-6
    np.testing.assert_array_equal(tt[pos], st[pos])
    np.testing.assert_array_equal(off, tt[np.arange(len(qs)), want])
    # a ragged batch
    assert t.search_top1_device(np.stack(qs[:3]))[1].tolist() == \
        t.search_top1_device(np.stack(qs))[1][:3].tolist()


def test_align_alpha_matches_jax():
    """score_alpha: per-shard row masks and the query mask make the exp
    transform exact (ragged lengths); no kernel in either package."""
    rng = np.random.default_rng(12)
    db, counts, song_pos = make_db(rng, n_songs=12, min_len=12, max_len=24)
    qs = []
    for ln in (8, 5, 8, 3):
        song = int(rng.integers(0, len(counts)))
        off = int(rng.integers(0, counts[song] - ln))
        q = db[song_pos[song] + off : song_pos[song] + off + ln].copy()
        q += 0.1 * rng.standard_normal(q.shape).astype(np.float32)
        qs.append(q / np.linalg.norm(q, axis=1, keepdims=True))
    j, t = pair(db, counts, 4, engine="align", align_pad=16, score_alpha=1.5)
    assert_tables_equal(j, t, qs)
    assert_top1_equal(j, t, [q[:3] for q in qs])


# ------------------------------------------------------------ screen engine
@pytest.mark.parametrize("coarse_dtype,dtype", [(None, "float32"), ("int8", "float32"),
                                                (None, "bfloat16"), ("int8", "bfloat16")])
def test_screen_matches_jax_and_exhaustive(coarse_dtype, dtype):
    """Per-shard coarse prune + exact rescore: the survivors' tables and the
    top-1 equal JAX's sharded screen (the int8 copies under one scale
    across shards), and the winner is the exhaustive engine's."""
    rng = np.random.default_rng(21)
    db, counts, song_pos = make_db(rng, n_songs=24, min_len=10, max_len=30)
    j, t = pair(db, counts, 4, dtype=dtype, engine="screen", align_pad=16, screen_k=4,
                screen_top_m=5, screen_coarse_dtype=coarse_dtype)
    assert t.shards[0].coarse.dtype == (torch.int8 if coarse_dtype else getattr(torch, dtype))
    assert len(set(t.resident_bytes())) == 1
    qs, want = noisy_queries(rng, db, counts, song_pos, 6, 6, noise=lambda b: 0.03)
    single = AlignmentEngine(db, counts, pad=16, score_dtype=torch.float32, device=CPU)
    ss, st = single.search(np.stack(qs), np.full(len(qs), 6))
    if dtype == "float32":
        tm, tt = assert_tables_equal(j, t, qs)
        songs, _, _ = assert_top1_equal(j, t, qs)
    else:
        jm, jt = j.query_batch(qs)
        tm, tt = t.query_batch(qs)
        np.testing.assert_array_equal(tm != 0, jm != 0)  # the same survivors
        np.testing.assert_allclose(tm, jm, atol=0.004)
        top2 = np.sort(ss, axis=1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > BF16_MARGIN
        assert clear.sum() >= 4
        np.testing.assert_array_equal(tt[clear], jt[clear])
        songs = t.flat_to_song(t.search_top1_rescued(np.stack(qs))[1])
    assert songs.tolist() == want == np.argmax(ss, axis=1).tolist()
    surv = tm != 0
    np.testing.assert_allclose(tm[surv], ss[surv], rtol=1e-5 if dtype == "float32" else 0,
                               atol=1e-6 if dtype == "float32" else 0.01)


def test_screen_alpha_matches_jax_and_align_alpha():
    rng = np.random.default_rng(13)
    db, counts, song_pos = make_db(rng, n_songs=16, min_len=16, max_len=28)
    qs, _ = noisy_queries(rng, db, counts, song_pos, 6, 8,
                          noise=lambda b: 0.46 if b % 2 else 0.1)
    ja, ta = pair(db, counts, 4, engine="align", align_pad=16, score_alpha=2.0)
    j, t = pair(db, counts, 4, engine="screen", align_pad=16, screen_k=4, screen_top_m=2,
                screen_rescue=0.4, score_alpha=2.0)
    assert t.rescue_tau == pytest.approx(np.exp(-2.0 * 0.6 ** 2))
    tm, tt = assert_tables_equal(j, t, qs)
    rm, rt = ta.query_batch(qs)
    win = np.argmax(rm, axis=1)
    b = np.arange(len(qs))
    assert (np.argmax(tm, axis=1) == win).all()
    np.testing.assert_allclose(tm[b, win], rm[b, win], rtol=1e-5)
    np.testing.assert_array_equal(tt[b, win], rt[b, win])
    songs, val, off = assert_top1_equal(j, t, qs)
    assert songs.tolist() == win.tolist()
    np.testing.assert_array_equal(off, rt[b, win])


def test_screen_rescue_gate_is_global():
    """The winner-dropping regime (top_m 1, heavy noise): the bare stages
    1+2 miss, and the rescue, gated on the MERGED answer and rescored on
    every shard, gives the sharded exhaustive engine's answers, on the
    tables and on the top-1 paths, equal to JAX's."""
    rng = np.random.default_rng(26)
    db, counts, song_pos = make_db(rng, n_songs=24, min_len=16, max_len=30)
    qs, want = noisy_queries(rng, db, counts, song_pos, 6, 10,
                             noise=lambda b: 0.46 if b % 2 else 0.1)
    _, ref = pair(db, counts, 4, engine="align", align_pad=16)
    rm, rt = ref.query_batch(qs)
    assert np.argmax(rm, axis=1).tolist() == want
    j, t = pair(db, counts, 4, engine="screen", align_pad=16, screen_k=4, screen_top_m=1,
                screen_rescue=0.4)
    bare, _, _ = assert_top1_equal(j, t, qs, rescued=False)
    assert bare.tolist() != want, "regime too easy: bare top-1 already exact"
    tm, tt = assert_tables_equal(j, t, qs)
    songs, val, off = assert_top1_equal(j, t, qs)
    b = np.arange(len(qs))
    assert songs.tolist() == want == np.argmax(tm, axis=1).tolist()
    np.testing.assert_allclose(val * 10, tm[b, want] * 10, rtol=1e-5)
    np.testing.assert_array_equal(off, rt[b, want])


def test_screen_top1_device_matches_query_batch():
    rng = np.random.default_rng(22)
    db, counts, song_pos = make_db(rng, n_songs=24, min_len=10, max_len=30)
    j, t = pair(db, counts, 4, engine="screen", align_pad=16, screen_k=4, screen_top_m=5)
    targets = [2, 11, 19]
    qpad = np.stack([db[song_pos[s] + 2 : song_pos[s] + 8]
                     + 0.03 * rng.standard_normal((6, 16)).astype(np.float32)
                     for s in targets])
    val, idx, off = t.search_top1_device(qpad)
    assert val.dtype == torch.float32 and idx.dtype == torch.int64
    assert t.flat_to_song(idx).tolist() == targets
    assert off.tolist() == [2, 2, 2]
    smax, _ = t.query_batch(list(qpad))
    np.testing.assert_allclose(val.numpy(), smax[np.arange(3), targets], rtol=1e-5)
    assert_top1_equal(j, t, list(qpad))


def test_screen_topm_exceeds_shard_size():
    """1-2 songs a shard, top_m 5: padding survivors score -inf, never win
    and never reach the tables."""
    rng = np.random.default_rng(24)
    db, counts, song_pos = make_db(rng, n_songs=6, min_len=10, max_len=20)
    j, t = pair(db, counts, 4, engine="screen", align_pad=16, screen_k=4, screen_top_m=5)
    q = db[song_pos[4] + 1 : song_pos[4] + 7] + 0.03 * rng.standard_normal(
        (6, 16)).astype(np.float32)
    tm, _ = assert_tables_equal(j, t, [q])
    assert np.isfinite(tm).all() and int(np.argmax(tm[0])) == 4
    songs, val, _ = assert_top1_equal(j, t, [q])
    assert songs.tolist() == [4] and np.isfinite(val).all()


def test_screen_more_shards_than_songs():
    rng = np.random.default_rng(25)
    db, counts, song_pos = make_db(rng, n_songs=6, min_len=10, max_len=20)
    j, t = pair(db, counts, 8, engine="screen", align_pad=16, screen_k=4, screen_top_m=3,
                screen_rescue=0.4)
    assert (t.song_map[6:] == -1).all()  # two empty shards
    q = db[song_pos[2] + 1 : song_pos[2] + 7] + 0.03 * rng.standard_normal(
        (6, 16)).astype(np.float32)
    tm, _ = assert_tables_equal(j, t, [q])
    assert np.isfinite(tm).all() and int(np.argmax(tm[0])) == 2
    assert assert_top1_equal(j, t, [q])[0].tolist() == [2]


# ------------------------------------------------------------ Database
def _write(tmp_path, db, counts, d):
    root = str(tmp_path / "db")
    os.makedirs(root)
    db.tofile(os.path.join(root, "embeddings"))
    counts.astype(np.int32).tofile(os.path.join(root, "landmarkKey"))
    with open(os.path.join(root, "songList.txt"), "w") as f:
        f.write("".join("s%d\n" % i for i in range(len(counts))))
    write_index_meta(root, d=d)
    return root


def _databases(root, params):
    from pfann_tpu.index.database import Database as JaxDatabase

    jdb = JaxDatabase(root, params, hop_size=0.5)
    tdb = Database(root, params, hop_size=0.5, device=CPU, devices=[CPU] * 8)
    assert jdb._sharded is not None and tdb._sharded is not None
    assert tdb._sharded.engine == jdb._sharded.engine
    assert tdb._sharded.n_shards == 8
    return jdb, tdb


def _assert_databases_equal(jdb, tdb, queries):
    for (ts, ta), (js, ja) in zip(tdb.query_top1_batch(queries),
                                  jdb.query_top1_batch(queries)):
        assert ta == ja
        assert ts == pytest.approx(js, rel=1e-5)
    for (ts, ta, ttab), (js, ja, jtab) in zip(tdb.query_embeddings_batch(queries),
                                              jdb.query_embeddings_batch(queries)):
        assert ta == ja
        assert ts == pytest.approx(js, rel=1e-5)
        np.testing.assert_allclose(ttab, jtab, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("engine,fsm", [("align", 1), ("screen", 1), ("align", 2)])
def test_database_sharded_matches_jax(tmp_path, engine, fsm):
    rng = np.random.default_rng({"align": 9, "screen": 23}[engine] + fsm)
    db, counts, song_pos = make_db(rng, n_songs=16, min_len=12, d=8)
    root = _write(tmp_path, db, counts, 8)
    params = {"top_k": 5, "db_dtype": "float32", "sharded": True, "engine": engine,
              "screen_top_m": 4, "backend": "exact", "frame_shift_mul": fsm}
    jdb, tdb = _databases(root, params)
    queries = []
    for s, L in ((3, 6), (13, 5), (8, 9)):
        base = db[song_pos[s] + 1 : song_pos[s] + 1 + -(-L // fsm)]
        q = np.repeat(base, fsm, axis=0)[:L].copy()
        q += 0.05 * rng.standard_normal(q.shape).astype(np.float32)
        queries.append(q)
    _assert_databases_equal(jdb, tdb, queries)
    assert [a[1][0] for a in tdb.query_top1_batch(queries)] == [3, 13, 8]
    # without devices, on the CPU: unsharded, as JAX on one device
    assert Database(root, params, hop_size=0.5, device=CPU)._sharded is None


def test_database_sharded_align_pad_plumbed(tmp_path):
    rng = np.random.default_rng(11)
    db, counts, _ = make_db(rng, n_songs=10, d=8)
    root = _write(tmp_path, db, counts, 8)
    params = {"top_k": 5, "db_dtype": "float32", "engine": "align", "sharded": True,
              "align_pad": 48}
    jdb, tdb = _databases(root, params)
    assert tdb._sharded.pad == jdb._sharded.pad == 48
    assert tdb._use_align(40)  # 32 < 40 <= 48: stays on the fast engine
    q = db[:40] + 0.05 * rng.standard_normal((40, 8)).astype(np.float32)
    _assert_databases_equal(jdb, tdb, [q, q[:33]])


# ------------------------------------------------------------ data parallel
DP_CFG = {
    "batch_size": 16, "sample_rate": 8000, "stft_n": 1024, "stft_hop": 256,
    "n_mels": 256, "f_min": 300, "f_max": 4000, "segment_size": 1, "hop_size": 0.5,
    "epoch": 1, "lr": 1e-3, "tau": 0.05, "cutout_min": 0.1, "cutout_max": 0.5,
    "mock_sizes": [48, 16], "model": {"d": 16, "h": 64, "u": 8, "fuller": True},
}
SPAWN_TIMEOUT = 120  # a hung rank fails the test instead of stalling the suite


def _dp_step_rank(rank, world, port, dtype, state, x, draws, out):
    """One rank of the data-parallel step on its rows of x (one gloo rank a
    process); rank 0 saves the loss, the summed grads and the val ranks."""
    import torch.distributed as dist

    from pfann_tpu_torch.data.mock import MockedDataLoader
    from pfann_tpu_torch.parallel.mesh import init_data_parallel, row_block
    from pfann_tpu_torch.train.trainer import Trainer

    torch.set_num_threads(2)
    init_data_parallel(rank, world, port, device=CPU)
    try:
        tr = Trainer(DP_CFG, compute_dtype=getattr(torch, dtype), device="cpu",
                     group=dist.group.WORLD)
        tr.init_state()
        tr.model.load_state_dict(state)
        tr.sync_params()
        ranks = tr.ranks(MockedDataLoader("train", DP_CFG), MockedDataLoader("validate", DP_CFG))
        r0, r1 = row_block(len(x), rank, world)
        loss = tr.train_step(torch.from_numpy(x[r0:r1]), draws, len(x))
        if rank == 0:
            torch.save({"loss": float(loss), "ranks": torch.from_numpy(ranks),
                        "grads": {n: p.grad for n, p in tr.model.named_parameters()}}, out)
    finally:
        dist.destroy_process_group()


def _port_step(dtype, state, x, draws):
    from pfann_tpu_torch.train.trainer import Trainer

    tr = Trainer(DP_CFG, compute_dtype=getattr(torch, dtype), device="cpu")
    tr.init_state()
    tr.model.load_state_dict(state)
    loss = tr.train_step(torch.from_numpy(x), draws)
    return tr, float(loss), {n: p.grad for n, p in tr.model.named_parameters()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dp_step_is_the_full_batch_step(tmp_path, dtype):
    """2 gloo ranks, 8 rows each: the loss equals the port's one-process
    step's (rtol 1e-5) and, in f32, JAX's 8-device mesh step's (rtol 1e-5);
    the summed grads equal the one-process grads and JAX's mesh grads (rtol
    3e-3, atol 1e-4, JAX's own mesh-vs-one-device tolerance; bf16, where
    each rank's conv backward rounds its partial sums to bf16: within 1e-2
    of each tensor's norm); validation ranks equal the one-process ranks; a
    shard-local loss would miss by far more than the tolerance."""
    from pfann_tpu_torch.data.mock import MockedDataLoader
    from pfann_tpu_torch.parallel.mesh import spawn_ranks
    from pfann_tpu_torch.train.trainer import Trainer
    from pfann_tpu_torch.utils.checkpoint import params_from_flax
    from tests.test_torch_port_train import _jax_draws, _torch_tree

    import jax

    x = np.random.default_rng(0).random((16, 256, 32), dtype=np.float32)
    key = jax.random.key(0)
    draws = _jax_draws(key, 256, 32)
    if dtype == "float32":
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P

        from pfann_tpu.parallel.mesh import make_mesh
        from pfann_tpu.train.loss import similarity_loss as jax_loss
        from pfann_tpu.train.trainer import Trainer as JaxTrainer

        mesh_tr = JaxTrainer(DP_CFG, compute_dtype=jnp.float32, mesh=make_mesh("dp", 8))
        pm, _ = mesh_tr.init_state()
        p0 = jax.tree.map(np.array, pm)
        state = params_from_flax(_torch_tree(p0))

        # JAX's mesh step's loss and grads, through its shardings (params
        # replicated, rows split over the 8 devices)
        def loss_fn(p, xb, k):
            return jax_loss(mesh_tr.model.apply(p, mesh_tr.specaug.augment(k, xb)),
                            mesh_tr.tau)

        repl = NamedSharding(mesh_tr.mesh, P())
        jloss, gm = jax.jit(
            jax.value_and_grad(loss_fn), out_shardings=repl,
            in_shardings=(repl, NamedSharding(mesh_tr.mesh, P("dp")), repl))(
            jax.device_put(p0, repl), jnp.asarray(x), key)
        jgrads = params_from_flax(_torch_tree(jax.tree.map(np.array, gm)))
        assert len(jgrads) >= 10
    else:
        init = Trainer(DP_CFG, compute_dtype=torch.bfloat16, device="cpu")
        init.init_state(seed=5)
        state = init.model.state_dict()

    out = str(tmp_path / "rank0.pt")
    spawn_ranks(_dp_step_rank, 2, args=(dtype, state, x, draws, out), timeout=SPAWN_TIMEOUT)
    got = torch.load(out)
    fresh, one_loss, one_grads = _port_step(dtype, state, x, draws)
    np.testing.assert_allclose(got["loss"], one_loss, rtol=1e-5)
    for want in [one_grads] + ([jgrads] if dtype == "float32" else []):
        for name, g in want.items():
            if dtype == "float32":
                np.testing.assert_allclose(got["grads"][name].numpy(), g.numpy(),
                                           rtol=3e-3, atol=1e-4, err_msg=name)
            else:
                assert float((got["grads"][name] - g).norm()) <= 1e-2 * float(g.norm()), name
    fresh.model.load_state_dict(state)  # the ranks of the weights before the step
    np.testing.assert_array_equal(
        got["ranks"].numpy(), fresh.ranks(MockedDataLoader("train", DP_CFG),
                                          MockedDataLoader("validate", DP_CFG)))
    # a shard-local loss (each rank's 8 rows alone) is not this loss
    local = np.mean([_port_step(dtype, state, x[r0:r1], draws)[1] for r0, r1 in ((0, 8), (8, 16))])
    assert abs(local - one_loss) > 100 * 1e-5 * abs(one_loss)
    if dtype == "float32":
        np.testing.assert_allclose(got["loss"], float(jloss), rtol=1e-5)


def _dp_fit_rank(rank, world, port, cfg):
    """One rank of an f32 ``fit`` on the mock loaders (gloo)."""
    import torch.distributed as dist

    from pfann_tpu_torch.data.mock import MockedDataLoader
    from pfann_tpu_torch.parallel.mesh import init_data_parallel
    from pfann_tpu_torch.train.trainer import Trainer

    torch.set_num_threads(2)
    group = None
    if world > 1:
        init_data_parallel(rank, world, port, device=CPU)
        group = dist.group.WORLD
    try:
        tr = Trainer(cfg, compute_dtype=torch.float32, device="cpu", group=group)
        tr.fit(MockedDataLoader("train", cfg), MockedDataLoader("validate", cfg))
    finally:
        if group is not None:
            dist.destroy_process_group()


def test_dp_fit_two_ranks_writes_once(tmp_path, monkeypatch):
    """fit as 2 gloo ranks: rank 0 alone writes the checkpoint contract's
    files (each metric once), and the epoch loss is the one-process fit's
    (rtol 1e-5).  (The weights after the epoch differ in the last bits, so
    validation ranks are compared on equal weights, in the step test.)"""
    from pfann_tpu_torch.parallel.mesh import spawn_ranks

    monkeypatch.chdir(tmp_path)
    cfg = dict(DP_CFG, mock_sizes=[32, 16])
    spawn_ranks(_dp_fit_rank, 2, args=(dict(cfg, model_dir=str(tmp_path / "dp")),),
                timeout=SPAWN_TIMEOUT)
    _dp_fit_rank(0, 1, 0, dict(cfg, model_dir=str(tmp_path / "one")))
    runs = {}
    for name in ("dp", "one"):
        for fn in ("checkpoint0.ckpt", "epochs.txt", "date.txt", "metrics.jsonl",
                   "model.msgpack"):
            assert os.path.exists(tmp_path / name / fn), (name, fn)
        with open(tmp_path / name / "metrics.jsonl") as f:
            runs[name] = {m["tag"]: m["value"] for m in map(json.loads, f)}
    with open(tmp_path / "dp" / "metrics.jsonl") as f:
        assert len(f.readlines()) == len(runs["dp"])  # written once, by rank 0
    assert runs["dp"].keys() == runs["one"].keys()
    np.testing.assert_allclose(runs["dp"]["train/loss"], runs["one"]["train/loss"], rtol=1e-5)


def test_train_cli_dp(tmp_path, monkeypatch, capfd):
    """--dp --mock --device cpu end to end (one gloo rank in a child), and
    JAX's message where 2*batch_size does not divide over the cards."""
    from pfann_tpu_torch.train import __main__ as cli

    monkeypatch.chdir(tmp_path)  # the CLI logs under ./logs
    cfg = dict(DP_CFG, model_dir=str(tmp_path / "m"), mock_sizes=[16, 8])
    path = str(tmp_path / "cfg.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    cli.main(["train", "-p", path, "--mock", "-w", "0", "--dp", "--device", "cpu"])
    out = capfd.readouterr().out
    assert "data-parallel over 1 devices" in out and "validate score" in out
    for fn in ("checkpoint0.ckpt", "configs.json", "metrics.jsonl", "model.msgpack"):
        assert os.path.exists(os.path.join(cfg["model_dir"], fn)), fn
    monkeypatch.setattr(cli, "resolve_device", lambda name: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    with pytest.raises(SystemExit, match=r"--dp needs 2\*batch_size \(32\) divisible by "
                                         r"the device count \(3\)"):
        cli.main(["train", "-p", path, "--mock", "--dp"])


@pytest.mark.parametrize("device_corpus", [False, True])
def test_loader_parts_are_the_global_batch(pipeline_root, tmp_path, device_corpus):
    """Each rank's part (3 ranks: pairs straddle) holds its block of the
    global batch's interleaved rows, with the global row count; the draws
    are the global batch's, so the values agree up to the f32 rounding of
    a smaller batch's FFTs and matmuls (the datapipe tests' log-mel
    tolerance, 2e-3)."""
    from pfann_tpu_torch.data.mock import MockedDataLoader
    from pfann_tpu_torch.data.segments import SegmentedDataLoader
    from pfann_tpu_torch.parallel.mesh import row_block

    cfg = dict(pipeline_root, cache_dir=str(tmp_path / "caches"),
               device_corpus=device_corpus)
    loaders = [SegmentedDataLoader("train", cfg, num_workers=1, device="cpu"),
               MockedDataLoader("train", dict(DP_CFG, batch_size=10))]
    for ld in loaders:
        ld.set_epoch(2)
        whole = [x.reshape((-1,) + tuple(x.shape[2:])) for x in ld]
        parts = []
        for r in range(3):
            ld.part = (r, 3)
            parts.append(list(ld))
        ld.part = None
        assert len(whole) > 1
        for i, x in enumerate(whole):
            for r in range(3):
                rows, n = parts[r][i]
                r0, r1 = row_block(len(x), r, 3)
                assert n == len(x)
                np.testing.assert_allclose(np.asarray(rows), np.asarray(x[r0:r1]),
                                           rtol=0, atol=2e-3)


# ------------------------------------------------------------ profiling
def test_profiling_helpers(tmp_path):
    from pfann_tpu_torch.utils import profiling

    profiling.enable()
    try:
        with profiling.device_trace(str(tmp_path / "prof")) as prof:
            with profiling.span("pfann_region", n=2):
                torch.ones(64, 64) @ torch.ones(64, 64)
        with profiling.span("pfann_region"):
            pass
    finally:
        profiling.disable()
    names = [e.key for e in prof.key_averages()]
    assert "pfann_region" in names
    traces = os.listdir(tmp_path / "prof")
    assert len(traces) == 1 and "pfann_region" in open(tmp_path / "prof" / traces[0]).read()
    summ = profiling.summary()
    assert list(summ) == ["pfann_region"]
    assert summ["pfann_region"]["calls"] == 2 and summ["pfann_region"]["n"] == 2
    with profiling.device_trace(str(tmp_path / "off"), enabled=False) as prof:
        assert prof is None
    assert not os.path.exists(tmp_path / "off")
