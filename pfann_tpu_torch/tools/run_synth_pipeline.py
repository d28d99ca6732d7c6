"""The round-3 synthetic pipeline on the port: regenerate the v2 family
corpus, train, build both systems, and evaluate per SNR at 10 s and 3 s.

    python -m pfann_tpu_torch.tools.run_synth_pipeline [--root DIR] \
        [--db-songs 1000] [--num-queries 2000] [--fsm 2,4] [--epochs N] \
        [--device cuda|cpu] [--jobs N]

The port of ``tools/run_synth_pipeline.sh``, step for step, from ``--root``
(default: the repository, where the script ``cd``s):
  corpus   ``python -m pfann_tpu_torch.tools.make_synth_corpus --db-songs N``
  train    ``python -m pfann_tpu_torch.train -p configs/synth.json -w 2``
  genall   ``python -m pfann_tpu_torch.genall gentest_synth synth N 10``, and
           ``synth3s N 3``
  testall  ``synth`` and ``lm`` on ``synth`` (with ``-build``) and ``synth3s``
  fuse     ``ensemble/fuse_synth.py --dataset synth3s --out out/ensemble3s``
  fsm      per ``--fsm`` value: ``tools/make_fsm_db.py``, one
           ``matcher --pairs --batch 128`` over the 10 s sets, and
           ``tools/accuracy.py`` per SNR
then ``PIPELINE_DONE``.  The script's fixed values are the flags'
defaults; ``--epochs`` defaults to the config's 40.  Where it differs, the
train step reads a copy of ``configs/synth.json`` under ``--root`` with
only ``epoch`` changed (``out/configs/synth_epoch<N>.json``).  The corpus
flags (``--train-songs``, ``--val-songs``, ``--test-songs``, ``--seconds``;
a run small enough for the CPU) are passed on to ``make_synth_corpus``
only when given, and ``--jobs N`` (default 1) to genall and testall.

Before the corpus, the driver deletes ``caches/*``, ``out/synth_dataset``
and ``out/models/synth`` under ``--root``, and nothing else anywhere: the
preprocess caches are keyed by file name, which a regenerated corpus
reuses, and a finished model refuses to retrain.  A root other than the
repository gets a copy of ``configs/`` (where it has none) and of
``ensemble/``: ``fuse_synth.py`` runs its steps with its own parent
directory as the working directory, so it runs from ``<root>/ensemble``.
The fuse step needs scikit-learn (``ensemble/svmtrain.py``); where it
cannot be imported the driver prints ``fuse: not run (scikit-learn is not
installed)`` and goes on.  Every other failing step stops the driver with
its exit code, as ``set -e`` does.  Each step prints ``step <name> <wall>
s``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import sys

from pfann_tpu_torch.utils.device import resolve_device
from pfann_tpu_torch.utils.harness import (
    REPO,
    SNRS,
    check,
    host_tool,
    port,
    repo_path,
    timed,
)

TRAIN_CONFIG = "configs/synth.json"
CORPUS_FLAGS = ("train_songs", "val_songs", "test_songs", "seconds")


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m pfann_tpu_torch.tools.run_synth_pipeline")
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--db-songs", type=int, default=1000)
    ap.add_argument("--num-queries", type=int, default=2000)
    ap.add_argument("--fsm", default="2,4", help="comma-separated frame_shift_mul values")
    ap.add_argument("--epochs", type=int, default=None,
                    help="training epochs (default: the config's)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--jobs", type=int, default=1,
                    help="per-SNR steps of genall and testall run at once")
    for flag in CORPUS_FLAGS:
        ap.add_argument("--" + flag.replace("_", "-"),
                        type=float if flag == "seconds" else int, default=None)
    return ap.parse_args(argv)


def _inside(root: str, path: str) -> str:
    """``path`` under ``root``; refuses anything that resolves outside."""
    full = os.path.realpath(os.path.join(root, path))
    if os.path.commonpath([full, root]) != root or full == root:
        raise SystemExit("refusing to delete %s: not under --root %s" % (full, root))
    return full


def clean(root: str) -> None:
    for path in glob.glob(os.path.join(root, "caches", "*")) + [
            os.path.join(root, "out", "synth_dataset"),
            os.path.join(root, "out", "models", "synth")]:
        full = _inside(root, os.path.relpath(path, root))
        if os.path.isdir(full) and not os.path.islink(full):
            shutil.rmtree(full)
        elif os.path.lexists(full):
            os.remove(full)


def stage(root: str) -> None:
    """What a root other than the repository needs of it."""
    if root == os.path.realpath(REPO):
        return
    if not os.path.exists(os.path.join(root, "configs")):
        shutil.copytree(repo_path("configs"), os.path.join(root, "configs"))
    shutil.copytree(repo_path("ensemble"), os.path.join(root, "ensemble"),
                    dirs_exist_ok=True, ignore=shutil.ignore_patterns("__pycache__"))


def train_config(root: str, epochs: int | None) -> str:
    with open(os.path.join(root, TRAIN_CONFIG)) as f:
        cfg = json.load(f)
    if epochs is None or epochs == cfg["epoch"]:
        return TRAIN_CONFIG
    cfg["epoch"] = epochs
    path = "out/configs/synth_epoch%d.json" % epochs
    os.makedirs(os.path.join(root, "out", "configs"), exist_ok=True)
    with open(os.path.join(root, path), "w") as f:
        json.dump(cfg, f, indent=2)
    return path


def have_sklearn() -> bool:
    try:
        import sklearn  # noqa: F401
    except ImportError:
        return False
    return True


def fuse(root: str) -> None:
    """The thesis ensemble over the 3 s sets, where scikit-learn is there."""
    if not have_sklearn():
        print("fuse: not run (scikit-learn is not installed)", flush=True)
        return
    timed("fuse", [sys.executable, os.path.join(root, "ensemble", "fuse_synth.py"),
                   "--dataset", "synth3s", "--out", "out/ensemble3s"], cwd=root)


def fsm_sweep(root: str, fsms: list[int], device: str) -> None:
    """The frame_shift_mul sweep: the exact-match lift of each fsm on the
    10 s sets; fsm is a query-time knob, so each DB variant links the
    base DB's files."""
    for fsm in fsms:
        db = "out/dbs/fsm%d_synth" % fsm
        check(host_tool("tools/make_fsm_db.py", "out/dbs/synth_synth", db, fsm),
              cwd=root, echo=True)
        pairs = []
        for snr in SNRS:
            pairs += ["out/queries/synth_snr%d/list.txt" % snr,
                      "out/results/fsm%d_synth_snr%d.txt" % (fsm, snr)]
        timed("matcher fsm%d" % fsm, port("matcher", "--pairs", "--batch", 128, db, *pairs,
                                          "--device", device), cwd=root)
        for snr in SNRS:
            print("fsm=%d snr=%d" % (fsm, snr), flush=True)
            check(host_tool("tools/accuracy.py", "out/queries/synth_snr%d/expected.csv" % snr,
                            "out/results/fsm%d_synth_snr%d_detail.csv" % (fsm, snr)),
                  cwd=root)


def main(argv: list[str] | None = None) -> None:
    args = parse_args(argv)
    resolve_device(args.device)
    root = os.path.realpath(args.root)
    fsms = [int(x) for x in args.fsm.split(",") if x]
    n = args.num_queries
    dev = ("--device", args.device)
    jobs = ("--jobs", args.jobs) if args.jobs > 1 else ()

    def step(name, cmd):
        timed(name, cmd, cwd=root)

    clean(root)
    stage(root)
    corpus = ["--db-songs", args.db_songs]
    for flag in CORPUS_FLAGS:
        if getattr(args, flag) is not None:
            corpus += ["--" + flag.replace("_", "-"), getattr(args, flag)]
    step("corpus", port("tools.make_synth_corpus", *corpus))
    step("train", port("train", "-p", train_config(root, args.epochs), "-w", 2, *dev))
    step("genall synth", port("genall", "gentest_synth", "synth", n, 10, *jobs))
    step("genall synth3s", port("genall", "gentest_synth", "synth3s", n, 3, *jobs))
    step("testall synth synth", port("testall", "synth", "synth", "-build", "-match_snr",
                                     "-accuracy_snr", *dev, *jobs))
    step("testall synth synth3s", port("testall", "synth", "synth3s", "-match_snr",
                                       "-accuracy_snr", *dev, *jobs))
    step("testall lm synth", port("testall", "lm", "synth", "-build", "-match_snr",
                                  "-accuracy_snr", *dev, *jobs))
    step("testall lm synth3s", port("testall", "lm", "synth3s", "-match_snr",
                                    "-accuracy_snr", *dev, *jobs))
    fuse(root)
    fsm_sweep(root, fsms, args.device)
    print("PIPELINE_DONE", flush=True)


if __name__ == "__main__":
    main()
