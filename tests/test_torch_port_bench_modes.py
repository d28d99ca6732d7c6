"""The port's benchmark, its other modes on the CPU: ``--lm`` and
``--build`` against the JAX package's ``bench.py`` (the same keys, song
count and depth; hash agreement >= 0.999, JAX's own bound on the card),
``--long``, ``--db`` (a DB built by the port's builder, as written and
with ``screen: true``) and ``--train-epoch``, which must run and print
``bench.py``'s keys for their mode (the port adds ``"device"``), and the
CLI, which refuses to run without a card unless ``--device cpu`` is given.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench as jax_bench
from pfann_tpu_torch import bench, builder
from pfann_tpu_torch.audio.io import write_wav
from pfann_tpu_torch.models.fp_network import build_fp_network, init_like_flax
from pfann_tpu_torch.utils.checkpoint import save_model
from tests.test_e2e import TINY_CFG, make_song
from tests.test_torch_port_bench import _few_threads, _last_json  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# bench.py's keys by mode (bench.py:378-392, 451-520, 750-791)
LONG_KEYS = {"metric", "unit", "S", "n_songs", "screen_pad128_qps", "value",
             "vs_baseline", "topk_qps"}
DB_KEYS = {"metric", "unit", "n_songs", "db", "engine", "value", "vs_baseline",
           "recall_sanity"}
DB_SCREEN_KEYS = DB_KEYS | {
    "align_control_qps", "align_control_recall", "bare_top1_qps",
    "rescued_top1_qps_clean", "rescued_top1_parity_clean", "rescued_top1_qps_noisy",
    "rescued_top1_parity_noisy", "rescued_search_qps_clean", "rescued_search_qps_noisy"}
TRAIN_KEYS = {"metric", "value", "unit", "epoch_s", "n_segments", "loss", "host_s",
              "dispatch_s", "device_corpus"}


@pytest.mark.parametrize("mode", ["landmark", "build"])
def test_landmark_and_build_modes_match_jax(mode, capsys):
    if mode == "landmark":
        jax_bench.landmark_bench(2, seconds=4.0)
        want = _last_json(capsys)
        got = bench.landmark_bench(2, seconds=4.0, device="cpu")
        assert got["hash_agreement"] >= 0.999
    else:
        jax_bench.build_bench(2, seconds=3.0)
        want = _last_json(capsys)
        got = bench.build_bench(2, seconds=3.0, device="cpu")
        assert len(got) == 1
        got = got[0]
        assert got["pipeline_depth"] == want["pipeline_depth"] == 8
        assert set(got["phase_split_s"]) == set(want["phase_split_s"])
    assert _last_json(capsys) == got
    assert set(got) == set(want) | {"device"}
    assert (got["metric"], got["unit"], got["n_songs"]) == (
        want["metric"], want["unit"], want["n_songs"])


@pytest.fixture(scope="module")
def tiny_db(tmp_path_factory):
    """A DB directory built by the port's builder: 6 songs x 12 s, a tiny
    model from a seed (written by the port's save_model)."""
    root = tmp_path_factory.mktemp("bench_db")
    rng = np.random.default_rng(5)
    lst = root / "songs.txt"
    with open(lst, "w") as fh:
        for i in range(6):
            path = str(root / ("s%d.wav" % i))
            write_wav(path, make_song(rng, n_sec=12), 8000)
            fh.write(path + "\n")
    model_dir = root / "model"
    model_dir.mkdir()
    cfg = dict(TINY_CFG, model_dir=str(model_dir), cache_dir=str(root / "caches"))
    with open(model_dir / "configs.json", "w") as fh:
        json.dump(cfg, fh)
    model = build_fp_network(cfg)
    init_like_flax(model, torch.Generator().manual_seed(0))
    save_model(str(model_dir / "model.msgpack"), model.state_dict())
    db_dir = str(root / "db")
    builder.main(["builder", str(lst), db_dir, str(model_dir), "--device", "cpu"])
    return db_dir


def _with_indexer(db_dir, tmp_path, **indexer):
    """A copy of db_dir's files whose configs.json indexer has ``indexer``."""
    out = tmp_path / "db"
    out.mkdir()
    for name in os.listdir(db_dir):
        with open(os.path.join(db_dir, name), "rb") as src, open(out / name, "wb") as dst:
            dst.write(src.read())
    cfg = json.load(open(out / "configs.json"))
    cfg["indexer"].update(indexer)
    with open(out / "configs.json", "w") as fh:
        json.dump(cfg, fh)
    return str(out)


@pytest.mark.parametrize("mode", ["long", "db-align", "db-screen", "train-epoch"])
def test_long_db_train_modes_run(mode, tiny_db, pipeline_root, tmp_path, capsys):
    if mode == "long":
        got = bench.long_query_bench(32, device="cpu")
        want = LONG_KEYS
        assert (got["S"], got["n_songs"]) == (119, 32)
    elif mode.startswith("db"):
        db_dir = (tiny_db if mode == "db-align" else
                  _with_indexer(tiny_db, tmp_path, screen=True, screen_coarse_dtype="int8"))
        got = bench.db_bench(db_dir, device="cpu")
        want = DB_KEYS if mode == "db-align" else DB_SCREEN_KEYS
        assert got["engine"] == mode[3:] and got["n_songs"] == 6
    else:
        cfg = dict(pipeline_root, cache_dir=str(tmp_path / "caches"),
                   model_dir=str(tmp_path / "model"))
        path = tmp_path / "train.json"
        with open(path, "w") as fh:
            json.dump(cfg, fh)
        got = bench.sustained_train(str(path), device="cpu")
        want = TRAIN_KEYS
        assert np.isfinite(got["loss"]) and got["n_segments"] > 0
    assert _last_json(capsys) == got
    assert set(got) == want | {"device"} and got["device"] == "cpu"


@pytest.mark.parametrize("argv", [[], ["--lm", "2"], ["--scale", "64"]])
def test_no_cuda_refuses(argv):
    """Without a card and without --device cpu the CLI exits non-zero and
    prints no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m", "pfann_tpu_torch.bench", *argv],
                       capture_output=True, text=True, cwd=REPO, env=env, timeout=120)
    assert r.returncode != 0
    assert "torch.cuda.is_available() is false" in r.stderr
    assert r.stdout.strip() == ""
