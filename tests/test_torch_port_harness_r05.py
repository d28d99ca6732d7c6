"""``python -m pfann_tpu_torch.tools.r05_calibrate`` and ``r05_flagship``
against ``tools/r05_calibrate.sh`` and ``tools/r05_flagship.sh``.

With their defaults, and with every variable the scripts read set, the
drivers issue the scripts' commands in the scripts' order (the port's
CLIs in place of the root scripts, ``--device`` added), each script run
with ``python`` and ``cat`` bash functions that record their argv
(tests/torch_harness_util.py).  One departure is kept on purpose: the
scripts' lists under ``/tmp/`` are written under the working directory's
``out/lists/``.  Without ``COVER_SUB``, ``r05_flagship`` exits 1 with the
script's message before any step, as the script does.

End to end, ``r05_flagship`` runs beside the script in scratch roots that
hold the same tiny corpora (``R5_ROOT``: 3 DB and 2 test songs of 12 s;
``R5M_ROOT``: 2 and 1 of 64 s; both covers at ``COVER_SUB`` 0.45), a model
at ``configs/synth.json``'s widths as ``out/models/flagship`` and
``out/dbs/flagship_30kbase`` built from the harness corpus: two 10 s
queries and one 60 s query a SNR.  The merged DB's configs are
byte-equal; the 10 s and 60 s results are held to JAX's as in
test_torch_port_harness_nn.py; the 60 s queries leave the fast engine for
the topk fallback in both packages, with the same log line; the accuracy
lines are equal up to the unclear queries.
"""

import contextlib
import glob
import os
import shutil
import subprocess
import sys

import pytest

from pfann_tpu_torch import builder
from pfann_tpu_torch.tools import make_synth_corpus, r05_calibrate, r05_flagship
from tests import torch_harness_util as hu

COVER = {"COVER_SUB": "0.45", "R5_ROOT": "out/r5t", "R5M_ROOT": "out/r5mt", "NQ10": "2",
         "NQ60": "1"}
# root, DB songs, test songs, seconds, seed
CORPORA = (("out/r5t", 3, 2, 12, 71), ("out/r5mt", 2, 1, 64, 72))
# the scripts' lists, and where the drivers write them
DEPARTURE = ("out/lists/", "tmp/")


def _as_script(steps):
    return [[w.replace(*DEPARTURE) if w.startswith(DEPARTURE[0]) else w for w in step]
            for step in steps]


@pytest.mark.parametrize("env", [{}, {"NQ": "7"}], ids=["defaults", "NQ"])
def test_r05_calibrate_matches_the_script(env, tmp_path, monkeypatch):
    want = hu.script_commands(str(tmp_path / "script"), "r05_calibrate", **env)
    for k in ("NQ",):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    (tmp_path / "driver").mkdir()
    monkeypatch.chdir(tmp_path / "driver")
    steps = hu.record_steps(monkeypatch, r05_calibrate)
    r05_calibrate.main(["r05_calibrate", "--device", "cpu"])
    assert _as_script(steps) == want
    assert want[0] == ["cat"] + ["out/cal_sub%d/lists/db.txt" % s for s in (10, 25, 45)]
    assert want[1][1:3] == ["builder.py", "tmp/cal_all_db.txt"]
    assert [w[w.index("--num") + 1] for w in want if "genquery.py" in w] == [
        env.get("NQ", "200")] * 6


@pytest.mark.parametrize("env", [
    {"COVER_SUB": "0.03"},
    {"COVER_SUB": "0.1", "NQ10": "20", "NQ60": "4", "COVER_JITTER": "0.02",
     "R5_ROOT": "out/a", "R5M_ROOT": "out/b"},
], ids=["defaults", "every-variable"])
def test_r05_flagship_matches_the_script(env, tmp_path, monkeypatch):
    want = hu.script_commands(str(tmp_path / "script"), "r05_flagship", **env)
    for k in ("NQ10", "NQ60", "COVER_SUB", "COVER_JITTER", "R5_ROOT", "R5M_ROOT"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    (tmp_path / "driver").mkdir()
    monkeypatch.chdir(tmp_path / "driver")
    steps = hu.record_steps(monkeypatch, r05_flagship)
    r05_flagship.main(["r05_flagship", "--device", "cpu"])
    assert _as_script(steps) == want
    assert len(want) == 2 + 2 + 3 + 16 + 1 + 16
    assert want[6][1:3] == ["tools/merge_dbs.py", "out/dbs/flagship_r5"]


def test_r05_flagship_needs_cover_sub(tmp_path):
    """Exit 1 and the script's message, before any step."""
    env = {k: v for k, v in hu.env().items() if k != "COVER_SUB"}
    (tmp_path / "script" / "tools").mkdir(parents=True)
    shutil.copy(os.path.join(hu.REPO, "tools", "r05_flagship.sh"), tmp_path / "script" / "tools")
    want = subprocess.run(["bash", "tools/r05_flagship.sh"], cwd=tmp_path / "script", env=env,
                          capture_output=True, text=True, timeout=60)
    (tmp_path / "driver").mkdir()
    got = subprocess.run([sys.executable, "-m", "pfann_tpu_torch.tools.r05_flagship",
                          "--device", "cpu"], cwd=tmp_path / "driver", env=env,
                         capture_output=True, text=True, timeout=120)
    assert want.returncode == got.returncode == 1
    assert want.stderr.strip().endswith(got.stderr.strip())
    assert got.stderr.strip() == "COVER_SUB: set COVER_SUB=0.NN from tools/r05_calibrate.sh"
    assert os.listdir(tmp_path / "driver") == [] and got.stdout == ""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("harness_r05")
    src = str(base / "src")
    hu.make_corpus(src)
    shutil.copytree(os.path.join(hu.REPO, "configs"), os.path.join(src, "configs"))
    hu.write_model(src)
    shutil.copytree(os.path.join(src, "out", "models", "synth"),
                    os.path.join(src, "out", "models", "flagship"))
    with contextlib.chdir(src), hu.few_threads():
        for root, songs, test, seconds, seed in CORPORA:
            make_synth_corpus.main([
                "make_synth_corpus", "--root", root, "--train-songs", "0", "--val-songs", "0",
                "--db-songs", str(songs), "--test-songs", str(test), "--seconds", str(seconds),
                "--family-size", "4", "--cover-frac", "1.0", "--cover-sub", COVER["COVER_SUB"],
                "--cover-jitter", "0.06", "--seed", str(seed)])
        builder.main(["builder", "out/synth_dataset/lists/db.txt", "out/dbs/flagship_30kbase",
                      "out/models/flagship", "--device", "cpu"])
    roots = {"jax": str(base / "jax"), "port": str(base / "port")}
    for side, root in roots.items():
        # mk_gentest writes into configs/: each root gets its own copy
        hu.clone(src, root, jax=side == "jax")
        os.remove(os.path.join(root, "configs"))
        shutil.copytree(os.path.join(src, "configs"), os.path.join(root, "configs"))
    out = hu.run_both(["bash", "tools/r05_flagship.sh"], roots["jax"],
                      hu.port("tools.r05_flagship", "--device", "cpu", "--jobs", 4),
                      roots["port"], PFANN_COMPILE_CACHE="", PFANN_PLATFORM="", **COVER)
    return roots, out


def _result(root, name, snr):
    return os.path.join(root, "out", "results", "flagship_%s_snr%d.txt" % (name, snr))


def test_r05_flagship_builds_the_same_db(runs):
    roots, (jax, port) = runs
    assert port.stdout.splitlines()[-1] == jax.stdout.splitlines()[-1] == "R05_PIPELINE_DONE"
    for rel in (("out", "dbs", "flagship_r5", "configs.json"),
                ("out", "dbs", "flagship_r5", "songList.txt"),
                ("configs", "gentest_r5m_snr-6.json")):
        assert hu.read(os.path.join(roots["port"], *rel)) == \
            hu.read(os.path.join(roots["jax"], *rel)), rel
    assert hu.read(os.path.join(roots["port"], "out", "lists", "r5_shard.txt")).count(b"\n") == 8


def test_r05_flagship_results_match_jax(runs):
    roots, (jax, port) = runs
    unclear, clear, total = [], 0, 0
    for name in ("r5", "r5m"):
        for snr in hu.SNRS:
            c, t, shifted = hu.compare_nn(_result(roots["jax"], name, snr),
                                          _result(roots["port"], name, snr))
            unclear, clear, total = unclear + [t - c + shifted], clear + c, total + t
    assert clear >= 0.5 * total, (clear, total)
    hu.compare_accuracy(jax.stdout, port.stdout, unclear)


def test_r05_flagship_60s_sets_take_the_same_engine(runs):
    """The flagship config sets no ``max_query_sec``, so the merged DB's
    layout pad is the engine default and the 60 s queries (119 windows)
    leave it for the topk fallback, in both packages."""
    roots, _ = runs
    lines = {}
    for side, root in roots.items():
        logs = glob.glob(os.path.join(root, "logs", "nnmatcher-*.log"))
        assert len(logs) == 1, logs
        with open(logs[0]) as f:
            lines[side] = sorted({ln.split("] ", 2)[-1].strip() for ln in f
                                  if "topk fallback" in ln})
    assert lines["port"] == lines["jax"] and len(lines["port"]) == 1
    assert lines["port"][0].startswith("query with 119 windows exceeds the align engine's")
