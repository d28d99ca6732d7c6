"""The port's benchmark (``pfann_tpu_torch/bench.py``) against the JAX
package's ``bench.py``, on the CPU: its scaffolding, the engine repairs it
needs, and ``--scale``.  The other modes: tests/test_torch_port_bench_main.py
and tests/test_torch_port_bench_modes.py.

Every mode runs at a tiny size with ``device="cpu"`` (the align-reduce
kernel's plain version).  What is compared here:
  * the corpus: the blocked draw equals ``bench.py``'s one-shot draw,
    bitwise; the batch recipe is ``bench.py``'s, bitwise;
  * the engines: a tensor batch gives a numpy batch's answers (a tensor
    already in the layout dtype reaches the kernel as it stands), both
    engines carry JAX's ``max_batch`` and chunk by it with equal answers;
  * ``--scale 64`` (with and without ``--int8-exact``): the same metric,
    unit, mode, song count, and recall strings as JAX's ``bench.main``,
    and the same keys (the port adds ``"device"``).
Timings on the CPU are printed and not checked: they are no device metric.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bench as jax_bench
import pfann_tpu.index.pallas_align as pa
from pfann_tpu.index.screen import ScreenedAlignmentEngine as JaxScreen
from pfann_tpu_torch import bench
from pfann_tpu_torch.index import align as talign
from pfann_tpu_torch.index import screen as tscreen


@pytest.fixture(autouse=True)
def _few_threads():
    """Two torch threads: the suite runs several workers on one machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


# ------------------------------------------------------------ scaffolding
@pytest.mark.parametrize("block_rows", [1, 7, 120, 1000, 1 << 18])
def test_unit_corpus_blocks_equal_one_draw(block_rows):
    n_songs, segs, d = 9, 50, 16
    rng = np.random.default_rng(0)  # bench.py:40-46
    want = rng.standard_normal((n_songs * segs, d)).astype(np.float32)
    want /= np.linalg.norm(want, axis=1, keepdims=True)
    got = bench.unit_corpus(n_songs, segs, d, block_rows=block_rows)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_make_batch_is_bench_recipe():
    """The module-level batch recipe against bench.py:112-127 written out."""
    emb = bench.unit_corpus(12, 30, 8)
    got, src = bench.make_batch(emb, 12, 30, 5, 7, seed=3, noise=0.2)
    r = np.random.default_rng(3)
    for b in range(5):
        song, off = int(r.integers(0, 12)), int(r.integers(0, 30 - 7))
        q = emb[song * 30 + off :][:7].copy()
        q += 0.2 * r.standard_normal((7, 8)).astype(np.float32)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        assert src[b] == song
        np.testing.assert_array_equal(got[b], q)


# ------------------------------------------------------------ engine repairs
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_align_engine_takes_tensor(dtype, monkeypatch):
    emb = bench.unit_corpus(6, 40, 16)
    counts = np.full(6, 40)
    eng = talign.AlignmentEngine(emb, counts, score_dtype=dtype, device="cpu")
    f, _ = bench.make_batch(emb, 6, 40, 10, 9, seed=1)
    want = eng.search_top1(f)
    for x in (torch.from_numpy(f), torch.from_numpy(f).to(dtype)):
        for a, b in zip(eng.search_top1(x), want):
            np.testing.assert_array_equal(a, b)
    # a tensor in the layout dtype reaches the kernel entry as it stands
    seen = []
    real = talign.align_reduce

    def spy(db, q, *args):
        seen.append(q.data_ptr())
        return real(db, q, *args)

    monkeypatch.setattr(talign, "align_reduce", spy)
    x = torch.from_numpy(f).to(dtype)
    eng.search_top1_device(x)
    assert seen == [x.data_ptr()]


def test_align_engine_max_batch_chunks():
    """max_batch is JAX's kernel batch (LANE_B) and chunks the dispatch;
    answers do not depend on it (JAX: tests/test_align.py:234)."""
    assert talign.MAX_BATCH == pa.LANE_B == 1024
    emb = bench.unit_corpus(5, 40, 16)
    eng = talign.AlignmentEngine(emb, np.full(5, 40), score_dtype=torch.float32,
                                 device="cpu")
    assert eng.max_batch == 1024
    f, _ = bench.make_batch(emb, 5, 40, 11, 6, seed=2)
    want = eng.search(f, np.full(11, 6))
    eng.max_batch = 4
    assert [b.shape[0] for b, _ in eng.search_device(f)] == [4, 4, 3]
    for a, b in zip(eng.search(f, np.full(11, 6)), want):
        np.testing.assert_array_equal(a, b)


def test_screen_max_batch(monkeypatch):
    """JAX's values (128 off the kernel, LANE_B on it); chunks honour it and
    leave the answers as they were."""
    emb = bench.unit_corpus(16, 40, 16)
    counts = np.full(16, 40)
    kw = dict(k=4, top_m=4, rescue_threshold=0.4)
    jeng = JaxScreen(emb, counts, score_dtype=jnp.float32, impl="xla", **kw)
    eng = tscreen.ScreenedAlignmentEngine(emb, counts, score_dtype=torch.float32,
                                          device="cpu", **kw)
    assert eng.max_batch == jeng.max_batch == tscreen.CPU_MAX_BATCH == 128
    assert eng._chunk_for(19) == 128
    f, _ = bench.make_batch(emb, 16, 40, 20, 19, seed=4, noise=0.4)
    want_top1, want_tab = eng.search_top1(f), eng.search(f, np.full(20, 19))
    eng.max_batch = 8
    assert eng._chunk_for(19) == 8
    calls = []
    real = eng._stage12
    monkeypatch.setattr(eng, "_stage12", lambda q, *a, **k: calls.append(len(q))
                        or real(q, *a, **k))
    got_top1, got_tab = eng.search_top1(f), eng.search(f, np.full(20, 19))
    assert calls == [8, 8, 4] * 2
    for a, b in zip(got_top1 + got_tab, want_top1 + want_tab):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ main modes
@pytest.mark.parametrize("int8_exact", [False, True])
def test_scale_mode_matches_jax(int8_exact, capsys, monkeypatch):
    for var in ("BENCH_SCREEN_K", "BENCH_SCREEN_M", "BENCH_SCREEN_DTYPE"):
        monkeypatch.delenv(var, raising=False)
    jax_bench.main(scale=64, int8_exact=int8_exact)
    want = _last_json(capsys)
    got = bench.main(scale=64, int8_exact=int8_exact, device="cpu")
    assert _last_json(capsys) == got
    same = ["metric", "unit", "mode", "n_songs", "recall_sanity"]
    if not int8_exact:
        same.append("recall_noisy")
    assert {k: got[k] for k in same} == {k: want[k] for k in same}
    assert got["recall_sanity"] == "128/128"
    assert set(got) == set(want) | {"device"} and got["device"] == "cpu"
    assert got["rescue_path"] == "host-gated"
