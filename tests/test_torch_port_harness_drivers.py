"""The harness drivers' own contracts on the CPU.

``run_synth_pipeline --device cpu --jobs 4`` runs end to end in a scratch
``--root`` at the smallest sizes the trainer takes (1 epoch over 2 songs of
12 s, one query per SNR) with scikit-learn hidden, as on the card machine: every
output is there, the fuse step prints that it did not run, the last line
is ``PIPELINE_DONE``, and nothing is written outside the root (not in the
working directory, not in the repository's ``out/``, ``caches/``,
``configs/`` or ``ensemble/``).  With its defaults the driver issues the
commands of ``tools/run_synth_pipeline.sh`` (the port's CLIs in place of
the root scripts, ``--device`` added).  Each driver that takes
``--device`` raises, before any step, where its default (cuda) finds no
card.
"""

import os
import re
import sys

import pytest
import torch

from pfann_tpu_torch import testall
from pfann_tpu_torch.tools import (
    r04_bench,
    r04_pipeline,
    r04_rescue,
    r04_scale30k,
    r04_scale30k_resume,
    r05_calibrate,
    r05_flagship,
    run_synth_pipeline,
)
from tests import torch_harness_util as hu

SMALL = ["--db-songs", "2", "--num-queries", "1", "--epochs", "1", "--train-songs", "2",
         "--val-songs", "1", "--test-songs", "1", "--seconds", "12"]
WATCHED = ("out", "caches", "configs", "ensemble")


def _snapshot():
    """(path, size, mtime) of everything under the repository's WATCHED
    directories."""
    seen = set()
    for top in WATCHED:
        for dirpath, dirs, names in os.walk(os.path.join(hu.REPO, top)):
            dirs[:] = [d for d in dirs if d != "__pycache__"]
            for name in dirs + names:
                st = os.lstat(os.path.join(dirpath, name))
                seen.add((os.path.join(dirpath, name), st.st_size, st.st_mtime_ns))
    return seen


def test_run_synth_pipeline_on_cpu(tmp_path, monkeypatch, capfd):
    root, cwd = tmp_path / "root", tmp_path / "cwd"
    root.mkdir()
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    monkeypatch.setattr(run_synth_pipeline, "have_sklearn", lambda: False)
    before = _snapshot()
    with hu.few_threads():
        run_synth_pipeline.main(["--root", str(root), "--device", "cpu", "--jobs", "4", *SMALL])
    out = capfd.readouterr().out
    assert out.splitlines()[-1] == "PIPELINE_DONE"
    assert "fuse: not run (scikit-learn is not installed)" in out.splitlines()
    for step in ("corpus", "train", "genall synth", "genall synth3s", "testall synth synth",
                 "testall synth synth3s", "testall lm synth", "testall lm synth3s",
                 "matcher fsm2", "matcher fsm4"):
        assert re.search(r"^step %s [0-9.]+ s$" % step, out, re.M), step
    # 8 SNRs x (4 testall arms + 2 fsm values), 1 query each
    blocks = hu.accuracy_blocks(out)
    assert len(blocks) == 48 and all(b[1][0].startswith("exact match") for b in blocks)

    at = lambda *p: os.path.join(str(root), *p)  # noqa: E731
    with open(os.path.join(hu.REPO, "configs", "synth.json")) as f:
        want = f.read()
    with open(at("out", "configs", "synth_epoch1.json")) as f:
        import json

        got, cfg = json.load(f), json.loads(want)
    assert got.pop("epoch") == 1 and cfg.pop("epoch") == 40 and got == cfg
    for path in (("out", "models", "synth", "model.msgpack"),
                 ("out", "dbs", "synth_synth", "embeddings"),
                 ("out", "dbs", "lm_synth", "landmarks.npz"),
                 ("out", "dbs", "fsm2_synth", "configs.json"),
                 ("out", "dbs", "fsm4_synth", "configs.json")):
        assert os.path.isfile(at(*path)), path
    for snr in hu.SNRS:
        for prefix in ("synth", "synth3s"):
            assert os.path.isfile(at("out", "queries", "%s_snr%d" % (prefix, snr), "list.txt"))
        for tag in ("synth_synth", "synth_synth3s", "fsm2_synth", "fsm4_synth"):
            assert os.path.isfile(at("out", "results", "%s_snr%d_detail.csv" % (tag, snr)))
        for tag in ("lm_synth", "lm_synth3s"):
            assert os.path.isfile(at("out", "results", "%s_snr%d.txt.csv" % (tag, snr)))
    assert os.listdir(str(cwd)) == []
    assert sorted(os.listdir(str(tmp_path))) == ["cwd", "root"]
    assert _snapshot() == before


def _script_commands():
    """The commands of tools/run_synth_pipeline.sh, the fsm loop unrolled,
    as argv lists."""
    with open(os.path.join(hu.REPO, "tools", "run_synth_pipeline.sh")) as f:
        text = f.read()
    head, loop = text.split("for fsm in 2 4; do")
    cmds = [line.split() for line in head.splitlines()
            if line.startswith(("python ", "./"))]
    for fsm in (2, 4):
        for line in loop.replace("\\\n", " ").splitlines():
            line = line.strip().replace("${fsm}", str(fsm))
            if line.startswith(("python tools/make_fsm_db.py", "python tools/accuracy.py")):
                cmds += [line.replace("${snr}", str(snr)).split()
                         for snr in (hu.SNRS if "${snr}" in line else (None,))]
            elif line.startswith("python matcher.py"):
                cmds.append(line.replace('"${pairs[@]}"', "").split() + [
                    "out/%s/%s_snr%d%s" % (kind, name, snr, ext) for snr in hu.SNRS
                    for kind, name, ext in (("queries", "synth", "/list.txt"),
                                            ("results", "fsm%d_synth" % fsm, ".txt"))])
    return cmds


def _as_script(cmd, root):
    """A driver's argv in the script's words."""
    cmd = [str(c) for c in cmd]
    assert cmd[0] == sys.executable
    if cmd[1] == "-m":
        name = cmd[2][len("pfann_tpu_torch."):]
        head = {"tools.make_synth_corpus": "tools/make_synth_corpus.py", "train": "train.py",
                "genall": "./genall.sh", "testall": "./testall.sh",
                "matcher": "matcher.py"}[name]
        rest = cmd[3:]
        if rest[-2:] == ["--device", "cpu"]:
            rest = rest[:-2]
        return (["python"] if head.endswith(".py") else []) + [head] + rest
    for base in (hu.REPO, root):
        if cmd[1].startswith(base + os.sep):
            return ["python", os.path.relpath(cmd[1], base)] + cmd[2:]
    raise AssertionError(cmd)


def test_run_synth_pipeline_defaults_match_the_script(tmp_path, monkeypatch, capsys):
    cmds = []
    monkeypatch.setattr(run_synth_pipeline, "timed",
                        lambda name, cmd, cwd=None: cmds.append(cmd))
    monkeypatch.setattr(run_synth_pipeline, "check",
                        lambda cmd, cwd=None, echo=False, code=None: cmds.append(cmd))
    monkeypatch.setattr(run_synth_pipeline, "have_sklearn", lambda: True)
    root = os.path.realpath(str(tmp_path))
    run_synth_pipeline.main(["--root", root, "--device", "cpu"])
    got = [_as_script(c, root) for c in cmds]
    want = _script_commands()
    assert got == want
    assert want[0] == ["python", "tools/make_synth_corpus.py", "--db-songs", "1000"]
    assert want[1] == ["python", "train.py", "-p", "configs/synth.json", "-w", "2"]
    assert want[2][-2:] == ["2000", "10"] and want[3][-2:] == ["2000", "3"]
    assert capsys.readouterr().out.splitlines()[-1] == "PIPELINE_DONE"


@pytest.mark.skipif(torch.cuda.is_available(), reason="the default device is there")
@pytest.mark.parametrize("driver,argv", [
    (testall, ["testall", "synth", "synth", "-build"]),
    (run_synth_pipeline, None),
    (r04_pipeline, ["r04_pipeline"]),
    (r04_rescue, ["r04_rescue"]),
    (r04_scale30k, []),
    (r04_scale30k_resume, ["r04_scale30k_resume"]),
    (r04_bench, ["r04_bench"]),
    (r05_calibrate, ["r05_calibrate"]),
    (r05_flagship, ["r05_flagship"]),
])
def test_default_device_raises_without_card(driver, argv, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "keep").write_text("")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        driver.main(argv if argv is not None else ["--root", str(tmp_path)])
    assert os.listdir(str(tmp_path)) == ["keep"]


def test_launch_log_appends_each_process_counts(tmp_path, monkeypatch):
    """A process whose kernel wrapper launched appends its counts by form
    to PFANN_LAUNCH_LOG as it exits (chip_smoke.py reads the harness's
    child processes so); one that launched nothing writes nothing."""
    import json

    from pfann_tpu_torch.index import align_kernel

    log = tmp_path / "launches.jsonl"
    monkeypatch.setenv(align_kernel.LAUNCH_LOG_ENV, str(log))
    fn = align_kernel.align_reduce
    monkeypatch.setattr(fn, "launches", 0)
    align_kernel._log_launches()
    assert not log.exists()
    monkeypatch.setattr(fn, "launches", 3)
    monkeypatch.setattr(fn, "launches_by_dtype",
                        {torch.float32: 0, torch.bfloat16: 2, torch.int8: 1})
    align_kernel._log_launches()
    align_kernel._log_launches()
    lines = [json.loads(x) for x in log.read_text().splitlines()]
    assert [x["launches"] for x in lines] == [{"float32": 0, "bfloat16": 2, "int8": 1}] * 2
