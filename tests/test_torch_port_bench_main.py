"""The port's benchmark, its exhaustive modes (``main``: the default, the
batch sweep and ``--sharded``) on the CPU, against the JAX package.

  * the default mode at 64 songs: its recall batch's top-1 songs and
    offsets equal JAX's ``AlignmentEngine.search_top1`` on the same corpus
    and (bf16-staged) batch where the port's top-1 margin exceeds 0.004*S
    (the bf16 tolerance of tests/test_torch_port_screen.py on sums; every
    query here clears it), scores within it;
  * the sweep: the kernel entry sees B = 128, 256 and 512, and
    ``max_batch`` is back at 1024 afterwards;
  * every mode prints ``bench.py``'s keys for it (the port adds
    ``"device"``).
``train_rows`` keeps the flagship train step at 8 rows here.
"""

import numpy as np
import torch

import jax.numpy as jnp

from pfann_tpu.index.align import AlignmentEngine as JaxAlignmentEngine
from pfann_tpu_torch import bench
from pfann_tpu_torch.index import align as talign
from tests.test_torch_port_bench import _few_threads  # noqa: F401  (autouse fixture)

BF16_SUM_ATOL = 0.004 * bench.S10
HEADLINE = {"metric", "value", "unit", "vs_baseline"}  # bench.py:186-191


def test_default_mode_small(capsys, monkeypatch):
    """The exhaustive mode at 64 songs; its recall batch's answers against
    JAX's exhaustive engine on the same corpus and (bf16-staged) batch."""
    first = []
    real = talign.AlignmentEngine.search_top1_device

    def spy(self, filters):
        out = real(self, filters)
        if not first:
            first.append((filters.float().numpy(), [x.numpy() for x in out[0]]))
        return out

    monkeypatch.setattr(talign.AlignmentEngine, "search_top1_device", spy)
    got = bench.main(n_songs=64, device="cpu", train_rows=8)
    assert set(got) == HEADLINE | {"train_step_ms", "device"}
    assert got["value"] > 0 and got["train_step_ms"] > 0
    filters, (song, score, t) = first[0]
    emb = bench.unit_corpus(64, bench.SEGS, bench.D)
    f0, src = bench.make_batch(emb, 64, bench.SEGS, 1024, bench.S10, 1)
    np.testing.assert_array_equal(
        filters, torch.from_numpy(f0).to(torch.bfloat16).float().numpy())
    np.testing.assert_array_equal(song, src)
    jeng = JaxAlignmentEngine(emb, np.full(64, bench.SEGS), score_dtype=jnp.bfloat16)
    jsong, jscore, jt = jeng.search_top1(jnp.asarray(f0, jnp.bfloat16))
    teng = talign.AlignmentEngine(emb, np.full(64, bench.SEGS), device="cpu")
    (best, _), = teng.search_device(f0)
    top2 = best.topk(2, dim=1).values
    clear = ((top2[:, 0] - top2[:, 1]) > BF16_SUM_ATOL).numpy()
    assert clear.all()
    np.testing.assert_array_equal(song[clear], np.asarray(jsong)[clear])
    np.testing.assert_array_equal(t[clear], np.asarray(jt)[clear])
    np.testing.assert_allclose(score, np.asarray(jscore), atol=BF16_SUM_ATOL)


def test_batch_sweep_lowers_max_batch(capsys, monkeypatch):
    seen = []
    real = talign.align_reduce

    def spy(db, q, *args):
        seen.append(q.shape[0])
        return real(db, q, *args)

    monkeypatch.setattr(talign, "align_reduce", spy)
    restored = []
    real_curve = bench._batch_curve

    def curve_spy(engine, batches, dev):
        before = engine.max_batch
        out = real_curve(engine, batches, dev)
        restored.append((before, engine.max_batch))
        return out

    monkeypatch.setattr(bench, "_batch_curve", curve_spy)
    got = bench.main(n_songs=8, batch_sweep=True, device="cpu", train_rows=8)
    assert {128, 256, 512} <= set(seen) and set(seen) <= {128, 256, 512, 1024}
    assert restored == [(1024, 1024)]
    assert [p["batch"] for p in got["batch_curve"]] == [128, 256, 512, 1024]
    assert set(got) == HEADLINE | {"batch_curve", "train_step_ms", "device"}


def test_sharded_mode_runs(capsys):
    got = bench.main(n_songs=8, sharded=True, device="cpu", train_rows=8)
    assert set(got) == HEADLINE | {"mode", "train_step_ms", "device"}
    assert got["mode"] == "sharded-1shard"
