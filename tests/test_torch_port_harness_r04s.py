"""``python -m pfann_tpu_torch.tools.r04_scale30k``, ``r04_scale30k_resume``
and ``r04_bench`` against ``tools/r04_scale30k.sh``,
``tools/r04_scale30k_resume.sh`` and ``tools/r04_bench.sh``.

With their defaults the drivers issue the scripts' commands in the
scripts' order (the port's CLIs in place of the root scripts, ``--device``
added): each script runs with ``python`` a bash function that records its
argv (tests/torch_harness_util.py), each driver with its step runners
patched to record.

End to end, both sides run in scratch roots that share one DB
(``out/dbs/synth_synth``, built by the port), the 10 s query sets and
their embeddings.  The JAX side starts with the distractor corpus (4
songs of 3 s, the driver's own generation command) and its shard built,
so the script skips both steps; the port side starts without them and
the driver writes and builds them (``--distract-songs 4 --seconds 3``),
byte for byte the same corpus.  Then both resumes run.  The merged and
control DBs' configs are byte-equal; every result is held to JAX's as in
test_torch_port_harness_r04.py (equal lines where JAX's top-1 margin
clears 4e-2, on at least half of the queries; every song score within
2e-2); the accuracy lines are equal up to the unclear queries; the bench
lines carry the same keys (the port's adds ``device``); and the
repository's files are as they were.
"""

import contextlib
import json
import os
import shutil

import pytest

from pfann_tpu_torch import builder, extractemb
from pfann_tpu_torch.tools import (
    make_synth_corpus,
    r04_bench,
    r04_pipeline,
    r04_scale30k,
    r04_scale30k_resume,
)
from tests import torch_harness_util as hu

NUM = 3
DISTRACT = (4, 3)
TAGS = ("synth30k", "alignctl30k")
WATCHED = ("out", "configs")


def _snapshot():
    """(path, size, mtime) of the repository's BENCH_r04_*.json and of
    everything under its WATCHED directories."""
    seen = set()
    paths = [os.path.join(hu.REPO, n) for n in os.listdir(hu.REPO) if n.startswith("BENCH_r04")]
    for top in WATCHED:
        for dirpath, dirs, names in os.walk(os.path.join(hu.REPO, top)):
            dirs[:] = [d for d in dirs if d != "__pycache__"]
            paths += [os.path.join(dirpath, n) for n in dirs + names]
    for path in paths:
        st = os.lstat(path)
        seen.add((path, st.st_size, st.st_mtime_ns))
    return seen


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    before = _snapshot()
    base = tmp_path_factory.mktemp("harness_r04s")
    src = str(base / "src")
    hu.make_corpus(src)
    os.symlink(os.path.join(hu.REPO, "configs"), os.path.join(src, "configs"))
    hu.make_queries(src, "synth", NUM, 10)
    hu.write_model(src)
    cpu = ("--device", "cpu")
    with contextlib.chdir(src), hu.few_threads():
        builder.main(["builder", "out/synth_dataset/lists/db.txt", "out/dbs/synth_synth",
                      "out/models/synth", *cpu])
        for snr in hu.SNRS:
            extractemb.main(["extractemb", "out/queries/synth_snr%d/list.txt" % snr,
                             "out/dbs/synth_synth", "out/qemb/synth_snr%d" % snr, *cpu])
        make_synth_corpus.main(
            ["make_synth_corpus", *r04_scale30k.distractor_corpus(*DISTRACT)[3:]])
        builder.main(["builder", "out/synth30k_distract/lists/db.txt", r04_scale30k.SHARD,
                      "out/models/synth", *cpu])
    # the script writes its results where r04_pipeline has made the folder
    os.makedirs(os.path.join(src, "out", "results"))
    roots = {"jax": str(base / "jax"), "port": str(base / "port")}
    hu.clone(src, roots["jax"], jax=True)
    hu.clone(src, roots["port"])
    for path in (r04_scale30k.DISTRACT_ROOT, r04_scale30k.SHARD):
        shutil.rmtree(os.path.join(roots["port"], path))
    flags = ("--distract-songs", DISTRACT[0], "--seconds", DISTRACT[1])
    out = {}
    for name, extra in (("r04_scale30k", flags), ("r04_scale30k_resume", ())):
        out[name] = hu.run_both(["bash", "tools/%s.sh" % name], roots["jax"],
                                hu.port("tools." + name, *cpu, "--jobs", 2, *extra),
                                roots["port"])
    return src, roots, out, before


def _recorded(tmp_path, monkeypatch, driver, argv, *modules):
    monkeypatch.chdir(tmp_path)
    steps = hu.record_steps(monkeypatch, driver, *modules)
    driver.main(argv)
    return steps


def test_r04_scale30k_defaults_match_the_script(tmp_path, monkeypatch):
    want = hu.script_commands(str(tmp_path / "script"), "r04_scale30k")
    (tmp_path / "driver").mkdir()
    got = _recorded(tmp_path / "driver", monkeypatch, r04_scale30k, ["--device", "cpu"],
                    r04_pipeline)
    assert got == want
    assert want[0][1:] == ["tools/make_synth_corpus.py", "--root", "out/synth30k_distract",
                           "--train-songs", "0", "--val-songs", "0", "--test-songs", "0",
                           "--db-songs", "9970", "--seconds", "60", "--seed", "777"]
    assert [w[1] for w in want[4:6]] == ["matchemb.py"] * 2 and len(want) == 23


def test_r04_scale30k_resume_matches_the_script(tmp_path, monkeypatch):
    want = hu.script_commands(str(tmp_path / "script"), "r04_scale30k_resume")
    (tmp_path / "driver").mkdir()
    got = _recorded(tmp_path / "driver", monkeypatch, r04_scale30k_resume,
                    ["r04_scale30k_resume", "--device", "cpu"], r04_scale30k, r04_pipeline)
    assert got == want
    assert want[0][-2:] == ["out/qemb/synth_snr8", "out/results/synth30k_snr8.txt"]


def test_r04_bench_matches_the_script(tmp_path, monkeypatch):
    want = hu.script_commands(str(tmp_path / "script"), "r04_bench")
    (tmp_path / "driver").mkdir()
    got = _recorded(tmp_path / "driver", monkeypatch, r04_bench,
                    ["r04_bench", "--device", "cpu"])
    assert got == want
    assert want[-1] == ["BENCH_SCREEN_DTYPE=int8", "bench.py", "--scale", "100000"]
    with open(os.path.join(hu.REPO, "tools", "r04_bench.sh")) as f:
        files = [w.split()[0] for w in f.read().split("| tee ")[1:]]
    assert [m[2] for m in r04_bench.MODES] == files


def test_r04_scale30k_writes_the_distractors_and_merges(runs):
    src, roots, _, _ = runs
    at = lambda side, *p: os.path.join(roots[side], *p)  # noqa: E731
    for sub in ("music", "lists"):
        corpus = os.path.join("out", "synth30k_distract", sub)
        assert hu.tree(os.path.join(src, corpus)) == hu.tree(at("port", corpus))
    songs = {side: hu.read(at(side, "out", "dbs", "synth30k", "songList.txt")).splitlines()
             for side in roots}
    assert songs["port"] == songs["jax"]
    assert len(songs["port"]) == 5 + DISTRACT[0]
    for name in ("synth30k", "alignctl30k"):
        rel = ("out", "dbs", name, "configs.json")
        assert hu.read(at("port", *rel)) == hu.read(at("jax", *rel)), name
    with open(at("port", "out", "dbs", "alignctl30k", "configs.json")) as f:
        assert json.load(f)["indexer"]["screen"] is False


def test_r04_scale30k_results_match_jax(runs):
    _, roots, out, _ = runs
    unclear, clear, total = [], 0, 0
    for tag in TAGS:
        for snr in hu.SNRS:
            c, t, shifted = hu.compare_nn(
                *(os.path.join(roots[s], "out", "results", "%s_snr%d.txt" % (tag, snr))
                  for s in ("jax", "port")))
            unclear, clear, total = unclear + [t - c + shifted], clear + c, total + t
    assert clear >= 0.5 * total, (clear, total)
    for name in ("r04_scale30k", "r04_scale30k_resume"):
        jax, port = out[name]
        assert [ln for ln in port.stdout.splitlines() if ln.startswith("model=")] == [
            "model=%s snr=%d" % (tag, snr) for tag in TAGS for snr in hu.SNRS]
        hu.compare_accuracy(jax.stdout, port.stdout, unclear)


def test_r04_scale30k_bench_line_matches_jax_keys(runs):
    _, roots, out, _ = runs
    want, got = (json.loads(hu.read(os.path.join(roots[s], "BENCH_r04_db30k.json")))
                 for s in ("jax", "port"))
    # the port's bench adds the card string under "device"
    assert sorted(set(got) - {"device"}) == sorted(want)
    assert got["db"] == want["db"] == "synth30k" and got["engine"] == want["engine"]
    line = hu.read(os.path.join(roots["port"], "BENCH_r04_db30k.json")).decode().strip()
    assert out["r04_scale30k_resume"][1].stdout.splitlines()[-2] == line


def test_r04_scale30k_leaves_the_repository_as_it_was(runs):
    assert _snapshot() == runs[3]
