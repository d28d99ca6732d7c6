"""The port's builder and matcher end to end against the JAX CLIs.

Reuses the ``corpus`` and ``db_and_model`` fixtures of tests/test_e2e.py
(a briefly trained tiny model and a JAX-built DB over 5 synthetic songs).
One subprocess runs the port's builder and matcher with ``--device cpu``
exactly as ``python -m pfann_tpu_torch.{builder,matcher}`` would, and
records which modules it imported: the port must pull in no jax, flax,
msgpack or ml_dtypes.  The matcher also serves a copy of the JAX-built DB
whose configs.json indexer says ``screen: true`` (int8 coarse stage, top 3
of the 5 songs survive), in default and ``--top1`` mode, against the JAX
matcher on the same copy.

Tolerances: both packages embed in bf16 (atol 2e-2 on unit-norm
embeddings, see test_torch_port_model.py) and score in bf16 storage, so
mean alignment scores agree within 2e-2.  Song ids, times and TSV bytes
must be equal.
"""

import csv
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from pfann_tpu.audio.io import write_wav
from tests.test_e2e import corpus, db_and_model  # noqa: F401  (fixtures)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EMB_ATOL = 2e-2
SCORE_ATOL = 2e-2

_PORT_RUN = r"""
import json, runpy, sys
def run(mod, *argv):
    sys.argv = [mod, *argv, "--device", "cpu"]
    runpy.run_module(mod, run_name="__main__")
lst, cfg, port_db, jax_db, qlist, out, screen_db = sys.argv[1:8]
run("pfann_tpu_torch.builder", lst, port_db, cfg)
run("pfann_tpu_torch.matcher", qlist, jax_db, out + "/result.txt")
run("pfann_tpu_torch.matcher", qlist, jax_db, out + "/result_top1.txt", "--top1")
run("pfann_tpu_torch.matcher", qlist, port_db, out + "/result_portdb.txt", "--top1")
run("pfann_tpu_torch.matcher", qlist, screen_db, out + "/result_screen.txt")
run("pfann_tpu_torch.matcher", qlist, screen_db, out + "/result_screen_top1.txt",
    "--top1")
with open(out + "/modules.json", "w") as f:
    json.dump(sorted(sys.modules), f)
"""


@pytest.fixture(scope="module")
def queries(corpus, tmp_path_factory):  # noqa: F811
    """The test_matcher_end_to_end query list: 6 hop-aligned 3 s crops."""
    root = tmp_path_factory.mktemp("queries")
    rng = np.random.default_rng(11)
    paths = []
    for qi in range(6):
        path, wav = corpus[int(rng.integers(0, len(corpus)))]
        start = int(rng.integers(0, len(wav) - 3 * 8000) // 4000 * 4000)
        qpath = str(root / f"q{qi}.wav")
        write_wav(qpath, wav[start : start + 3 * 8000].copy(), 8000)
        paths.append(qpath)
    qlist = str(root / "qlist.txt")
    with open(qlist, "w") as f:
        f.writelines(q + "\n" for q in paths)
    return qlist


SCREEN_INDEXER = {"screen": True, "screen_coarse_dtype": "int8", "screen_top_m": 3}


@pytest.fixture(scope="module")
def screen_db(db_and_model, tmp_path_factory):  # noqa: F811
    """A copy of the JAX-built DB whose configs.json indexer asks for the
    screened engine."""
    _, db_dir = db_and_model
    out = str(tmp_path_factory.mktemp("screen") / "db")
    shutil.copytree(db_dir, out)
    path = os.path.join(out, "configs.json")
    cfg = json.load(open(path))
    cfg["indexer"].update(SCREEN_INDEXER)
    with open(path, "w") as f:
        json.dump(cfg, f, indent=2)
    return out


@pytest.fixture(scope="module")
def jax_results(db_and_model, screen_db, queries, tmp_path_factory):  # noqa: F811
    """The JAX matcher's outputs on the same DB (and its screen copy) and
    queries."""
    sys.path.insert(0, REPO)
    import matcher as jax_matcher

    _, db_dir = db_and_model
    out = tmp_path_factory.mktemp("jax_out")
    for src, name in ((db_dir, "result.txt"), (screen_db, "result_screen.txt")):
        embedder, db, params = jax_matcher.load_model_and_db(src)
        jax_matcher.match_list(embedder, db, params, queries, str(out / name))
    assert db.engine == "screen"
    return str(out)


@pytest.fixture(scope="module")
def port_run(db_and_model, screen_db, queries, tmp_path_factory):  # noqa: F811
    cfg, db_dir = db_and_model
    root = os.path.dirname(db_dir)
    out = tmp_path_factory.mktemp("port_out")
    port_db = str(out / "port_db")
    env = {k: v for k, v in os.environ.items() if not k.startswith("PFANN_")}
    subprocess.run(
        [sys.executable, "-c", _PORT_RUN, os.path.join(root, "db_list.txt"),
         os.path.join(cfg["model_dir"], "configs.json"), port_db, db_dir,
         queries, str(out), screen_db],
        check=True, cwd=REPO, env=env, timeout=300,
    )
    return str(out), port_db


def _detail(path):
    return list(csv.reader(open(path)))


def test_port_imports_no_jax(port_run):
    out, _ = port_run
    mods = json.load(open(os.path.join(out, "modules.json")))
    assert "pfann_tpu_torch.index.align_kernel" in mods
    assert "pfann_tpu_torch.index.screen" in mods
    for banned in ("jax", "flax", "msgpack", "ml_dtypes"):
        assert not [m for m in mods if m == banned or m.startswith(banned + ".")], banned


def test_port_matcher_matches_jax(port_run, jax_results):
    """TSV bytes equal; _detail.csv ids and times equal, scores within
    tolerance; .bin tables within tolerance with equal answer times."""
    out, _ = port_run
    assert open(os.path.join(out, "result.txt"), "rb").read() == open(
        os.path.join(jax_results, "result.txt"), "rb").read()
    got = _detail(os.path.join(out, "result_detail.csv"))
    want = _detail(os.path.join(jax_results, "result_detail.csv"))
    assert got[0] == want[0] == ["query", "answer", "score", "time", "part_scores"]
    assert len(got) == len(want) == 7
    for g, w in zip(got[1:], want[1:]):
        assert g[:2] == w[:2] and g[3] == w[3]
        assert float(g[2]) == pytest.approx(float(w[2]), abs=SCORE_ATOL)
    tb = np.fromfile(os.path.join(out, "result.txt.bin"), np.float32).reshape(6, 5, 2)
    jb = np.fromfile(os.path.join(jax_results, "result.txt.bin"), np.float32).reshape(6, 5, 2)
    np.testing.assert_allclose(tb[..., 0], jb[..., 0], rtol=0, atol=SCORE_ATOL)
    best = tb[..., 0].argmax(axis=1)
    np.testing.assert_array_equal(best, jb[..., 0].argmax(axis=1))
    np.testing.assert_array_equal(tb[np.arange(6), best, 1], jb[np.arange(6), best, 1])
    songs = [l.split("\t")[1].strip() for l in open(os.path.join(out, "result.txt"))]
    assert len(songs) == 6 and "error" not in songs


def test_port_matcher_top1_same_tsv(port_run):
    """--top1 serves the same TSV and _detail answers, and no .bin."""
    out, _ = port_run
    assert open(os.path.join(out, "result_top1.txt"), "rb").read() == open(
        os.path.join(out, "result.txt"), "rb").read()
    assert not os.path.exists(os.path.join(out, "result_top1.txt.bin"))
    full = _detail(os.path.join(out, "result_detail.csv"))[1:]
    top1 = _detail(os.path.join(out, "result_top1_detail.csv"))[1:]
    for f, t in zip(full, top1):
        assert t[:2] == f[:2] and float(t[3]) == float(f[3])
        assert float(t[2]) == pytest.approx(float(f[2]), abs=1e-6)


def test_port_builder_matches_jax(db_and_model, port_run):  # noqa: F811
    """landmarkKey, songList.txt, index_meta.json (and the copied
    configs.json / model.msgpack) byte-equal to the JAX builder's;
    embeddings within tolerance and unit-norm."""
    _, db_dir = db_and_model
    _, port_db = port_run
    for name in ("landmarkKey", "songList.txt", "index_meta.json",
                 "configs.json", "model.msgpack"):
        assert open(os.path.join(port_db, name), "rb").read() == open(
            os.path.join(db_dir, name), "rb").read(), name
    te = np.fromfile(os.path.join(port_db, "embeddings"), np.float32).reshape(-1, 16)
    je = np.fromfile(os.path.join(db_dir, "embeddings"), np.float32).reshape(-1, 16)
    assert te.shape == je.shape == (75, 16)
    np.testing.assert_allclose(np.linalg.norm(te, axis=1), 1.0, atol=1e-4)
    np.testing.assert_allclose(te, je, rtol=0, atol=EMB_ATOL)


def test_each_package_serves_the_others_db(db_and_model, port_run):  # noqa: F811
    """The JAX Database loads the port-built DB and the port's Database
    loads the JAX-built one; the port's matcher on its own DB gives the
    JAX answers."""
    from pfann_tpu.index.database import Database as JaxDatabase
    from pfann_tpu_torch.index.database import Database as TorchDatabase

    cfg, db_dir = db_and_model
    out, port_db = port_run
    assert open(os.path.join(out, "result_portdb.txt"), "rb").read() == open(
        os.path.join(out, "result.txt"), "rb").read()
    jdb = JaxDatabase(port_db, cfg["indexer"], cfg["hop_size"])
    tdb = TorchDatabase(db_dir, cfg["indexer"], cfg["hop_size"], device="cpu")
    emb = np.fromfile(os.path.join(db_dir, "embeddings"), np.float32).reshape(-1, 16)
    queries = [emb[s * 15 + 3 : s * 15 + 9] for s in range(5)]
    for (js, (jid, jt)), (ts, (tid, tt)) in zip(
        jdb.query_top1_batch(queries), tdb.query_top1_batch(queries)
    ):
        assert (jid, jt) == (tid, tt)
        assert ts == pytest.approx(js, abs=SCORE_ATOL)
    assert [r[1] for r in tdb.query_top1_batch(queries)] == [
        (s, 1.5) for s in range(5)]


def test_port_matcher_serves_screen_db(port_run, jax_results, screen_db):
    """A DB whose indexer says screen: true is served by the screened engine
    through the port's matcher: the default and --top1 TSVs are byte-equal
    to the JAX matcher's on that DB.  (With 3 of 5 songs kept, the screen
    answers one query otherwise than the exhaustive engine, in both
    packages: the tiny model's margins are small and no score falls below
    the rescue cut.)"""
    from pfann_tpu_torch.index.database import Database as TorchDatabase

    out, _ = port_run
    want = open(os.path.join(jax_results, "result_screen.txt"), "rb").read()
    for name in ("result_screen.txt", "result_screen_top1.txt"):
        assert open(os.path.join(out, name), "rb").read() == want, name
    got = _detail(os.path.join(out, "result_screen_detail.csv"))
    jwant = _detail(os.path.join(jax_results, "result_screen_detail.csv"))
    assert len(got) == len(jwant) == 7
    for g, w in zip(got[1:], jwant[1:]):
        assert g[:2] == w[:2] and g[3] == w[3]
        assert float(g[2]) == pytest.approx(float(w[2]), abs=SCORE_ATOL)
    cfg = json.load(open(os.path.join(screen_db, "configs.json")))
    db = TorchDatabase(screen_db, cfg["indexer"], cfg["hop_size"], device="cpu")
    assert db.engine == "screen" and db._align.top_m == 3
