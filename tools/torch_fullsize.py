#!/usr/bin/env python
"""The harness recipes of rounds 4 and 5 at their own sizes on the port,
on one card, with the numbers their reports need.

    python tools/torch_fullsize.py r04 --root DIR --out DIR [--jobs 8]
    python tools/torch_fullsize.py r05 --root DIR --out DIR [--epochs N] \
        [--cover-sub 0.03] [--cover-jitter 0.02] [--jobs 8]

``r04``: ``python -m pfann_tpu_torch.tools.run_synth_pipeline --db-songs
20000`` (r04's 20,030-track DB) in ``--root``, then ``r04_pipeline``,
``r04_rescue``, ``r04_scale30k`` (9,970 distractors of 60 s, seed 777)
and ``r04_bench`` from it.  The distractor corpus is written by
``r04_scale30k``'s own generation command in the background while the
pipeline runs (host work on idle cores); the driver then skips that
step, as the script does where the list exists.  Then the 30k report:
songs and embeddings of ``synth30k``, which engine each DB picks, per
SNR the rescued screen's escalation share and the per-query
disagreements (ids and times) of ``synth30k`` and ``alignctl30k``.

``r05``: in the background, the two corpora of ``synth30k`` (the
pipeline's corpus command at ``--db-songs 20000`` and the distractors)
and the round-5 eval corpora; in front, ``synth_big`` (2,000 train and
200 validation songs of 30 s, seed 5) and ``python -m
pfann_tpu_torch.train`` on ``configs/flagship.json`` (a copy with only
``epoch`` changed where ``--epochs`` is given); then
``out/dbs/flagship_30kbase`` (``builder`` over the r04 DB list and the
distractor list with ``out/models/flagship``), the calibration corpora
``out/cal_sub{10,25,45}`` (120 DB + 40 test songs of 30 s, family size 4,
every song a cover, jitter 0.06, seeds 61-63), ``r05_calibrate`` and
``r05_flagship`` (``COVER_SUB``/``COVER_JITTER`` from the flags), and the
basename audit: every answer ``tools/accuracy.py`` credits (same
basename as the truth) whose path is not the truth's.

``--tiny --device cpu`` rehearses either recipe on the CPU at toy sizes
(a few songs, queries and epochs; no ``r04_bench``).

Each step's output goes whole to ``<out>/<step>.log``; this script prints
each step's wall, the card's name and power limit, and the reports.  The
results' ``.bin`` files (hundreds of MB a set at these sizes; no report
reads them) are deleted after each driver.
"""

from __future__ import annotations

import argparse
import csv
import glob
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from pfann_tpu_torch.tools import r04_scale30k  # noqa: E402
from pfann_tpu_torch.utils.harness import SNRS, child_env, port  # noqa: E402

ARGS = None
DB_SONGS = 20000  # r04's DB: 20,000 DB songs and 30 test songs
DISTRACT = (9970, 60)  # r04_scale30k's defaults: songs, seconds
# r05's corpora (DB songs, test songs, seconds; synth_big: train and
# validation songs) and query counts (the drivers' defaults where empty)
R05_SIZES = {"synth_dataset": ("--db-songs", 20000), "r5": (1500, 500, 30),
             "r5m": (120, 40, 90), "cal": (120, 40, 30),
             "synth_big": ("--train-songs", 2000, "--val-songs", 200, "--seconds", 30),
             "nq": {"NQ": "200"}}
# --tiny: the sizes of a rehearsal on the CPU
TINY_R05 = {"synth_dataset": ("--db-songs", 3, "--train-songs", 0, "--val-songs", 0,
                              "--test-songs", 2, "--seconds", 12),
            "r5": (3, 2, 12), "r5m": (2, 1, 62), "cal": (3, 2, 12),
            "synth_big": ("--train-songs", 4, "--val-songs", 2, "--seconds", 12),
            "nq": {"NQ": "2", "NQ10": "2", "NQ60": "1"}}
TINY_PIPELINE = ("--epochs", 1, "--train-songs", 2, "--val-songs", 1, "--test-songs", 2,
                 "--seconds", 12, "--num-queries", 3)


def card() -> str:
    """The card's name and power limit (nvidia-smi); "no card" without one."""
    if shutil.which("nvidia-smi") is None:
        return "no card"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def start(name: str, cmd: list, env: dict | None = None) -> tuple:
    log = open(os.path.join(ARGS.out, name + ".log"), "w")
    print("start %s: %s" % (name, " ".join(map(str, cmd))), flush=True)
    proc = subprocess.Popen([str(c) for c in cmd], cwd=ARGS.root, stdout=log,
                            stderr=subprocess.STDOUT, env=child_env() | (env or {}))
    return name, proc, log, time.perf_counter()


def wait(job: tuple) -> float:
    name, proc, log, t0 = job
    rc = proc.wait()
    log.close()
    wall = time.perf_counter() - t0
    print("step %s rc %d wall %.1f s  [%s]" % (name, rc, wall, card()), flush=True)
    if rc:
        with open(os.path.join(ARGS.out, name + ".log")) as f:
            print(f.read()[-4000:], flush=True)
        raise SystemExit("%s failed" % name)
    return wall


def run(name: str, cmd: list, env: dict | None = None) -> float:
    wall = wait(start(name, cmd, env))
    for path in glob.glob(os.path.join(ARGS.root, "out", "results", "*.bin")):
        os.remove(path)
    return wall


def lines_of(name: str, prefixes: tuple) -> None:
    """The log's lines that start with ``prefixes``, printed."""
    with open(os.path.join(ARGS.out, name + ".log")) as f:
        for line in f:
            if line.startswith(prefixes):
                print("  %s| %s" % (name, line.rstrip()), flush=True)


def detail(path: str) -> list[tuple[str, str, str]]:
    with open(path) as f:
        return [(r["query"], r["answer"], r["time"]) for r in csv.DictReader(f)]


def report_30k() -> None:
    import numpy as np
    import torch

    from pfann_tpu_torch.index.database import Database

    at = lambda *p: os.path.join(ARGS.root, *p)  # noqa: E731
    total = 0
    for name in ("synth30k", "alignctl30k"):
        with open(at("out", "dbs", name, "configs.json")) as f:
            params = json.load(f)
        db = Database(at("out", "dbs", name), params["indexer"], params["hop_size"],
                      torch.device(ARGS.device))
        print("30k %s: %d songs, %d embeddings, engine %s" % (
            name, len(db.songList), db.ntotal, db.engine), flush=True)
        if name != "synth30k":
            continue
        d = params["model"]["d"]
        for snr in SNRS:
            qdir = at("out", "qemb", "synth_snr%d" % snr)
            emb = np.fromfile(os.path.join(qdir, "query_embeddings"), np.float32).reshape(-1, d)
            idx = np.fromfile(os.path.join(qdir, "query_index"), np.int64).reshape(-1, 2)
            queries = [emb[a : a + n] for a, n in idx]
            before = getattr(db._align, "escalated", 0)
            for i in range(0, len(queries), 128):
                db.query_embeddings_batch(queries[i : i + 128])
            esc = getattr(db._align, "escalated", 0) - before
            auto, ctl = (detail(at("out", "results", "%s_snr%d_detail.csv" % (t, snr)))
                         for t in ("synth30k", "alignctl30k"))
            differ = sum(a != b for a, b in zip(auto, ctl)) + abs(len(auto) - len(ctl))
            total += differ
            print("30k snr %+d: %d queries, escalated %d (%.4f), synth30k != alignctl30k on "
                  "%d" % (snr, len(queries), esc, esc / max(len(queries), 1), differ),
                  flush=True)
        del db
    print("30k disagreements in all: %d" % total, flush=True)


def r04() -> None:
    root = ARGS.root
    dev, jobs = ("--device", ARGS.device), ("--jobs", ARGS.jobs)
    distract = start("distractors", r04_scale30k.distractor_corpus(*DISTRACT))
    run("run_synth_pipeline", port("tools.run_synth_pipeline", "--root", root, "--db-songs",
                                   DB_SONGS, *dev, *jobs, *(TINY_PIPELINE if ARGS.tiny else ())))
    lines_of("run_synth_pipeline", ("step ", "snr=", "fsm=", "exact", "near", "song"))
    for name in ("r04_pipeline", "r04_rescue"):
        run(name, port("tools." + name, *dev, *jobs))
    wait(distract)
    run("r04_scale30k", port("tools.r04_scale30k", *dev, "--jobs", 2))
    lines_of("r04_scale30k", ("=== ", "model=", "exact", "near", "song", "{"))
    if not ARGS.tiny:
        run("r04_bench", port("tools.r04_bench", *dev))
        lines_of("r04_bench", ("=== ", "{"))
    run("harness_report", [sys.executable, os.path.join(REPO, "tools",
                                                        "torch_harness_report.py"), root, *dev])
    lines_of("harness_report", ("snr",))
    report_30k()
    for path in glob.glob(os.path.join(root, "BENCH_r04_*.json")) + [
            os.path.join(root, "ACCURACY_r04.md")]:
        shutil.copy(path, ARGS.out)


def corpus(root: str, *flags) -> list:
    return port("tools.make_synth_corpus", "--root", root, *flags)


def audit() -> None:
    """Answers credited by basename (tools/accuracy.py; expected.csv names
    the true song by basename) whose path is not in the query set's own
    corpus."""
    at = lambda *p: os.path.join(ARGS.root, *p)  # noqa: E731
    sets = [("cal%d_snr%d" % (s, n), "cal%d_snr%d" % (s, n), "out/cal_sub%d" % s)
            for s in (10, 25, 45) for n in (-6, 0)]
    sets += [("%s_snr%d" % (k, n), "flagship_%s_snr%d" % (k, n), "out/synth_" + k)
             for k in ("r5", "r5m") for n in SNRS]
    credited = false = 0
    for qset, tag, corpus in sets:
        with open(at("out", "queries", qset, "expected.csv")) as f:
            truth = {r["query"]: r["answer"] for r in csv.DictReader(f)}
        for query, answer, _ in detail(at("out", "results", tag + "_detail.csv")):
            if os.path.basename(answer) == truth[os.path.basename(query)]:
                credited += 1
                false += os.path.dirname(os.path.normpath(answer)) != corpus + "/music"
    print("basename audit: %d answers credited, %d of them a path from another corpus"
          % (credited, false), flush=True)


def r05() -> None:
    root, z = ARGS.root, R05_SIZES
    dev, jobs = ("--device", ARGS.device), ("--jobs", ARGS.jobs)
    background = [start("corpus_synth_dataset", corpus("out/synth_dataset", *z["synth_dataset"])),
                  start("distractors", r04_scale30k.distractor_corpus(*DISTRACT))]
    # the r05 eval corpora: r05_flagship's own commands (it skips them then)
    for name, (songs, test, seconds), seed in (("synth_r5", z["r5"], 71),
                                               ("synth_r5m", z["r5m"], 72)):
        background.append(start("corpus_" + name, corpus(
            "out/" + name, "--train-songs", 0, "--val-songs", 0, "--db-songs", songs,
            "--test-songs", test, "--seconds", seconds, "--family-size", 4, "--cover-frac",
            "1.0", "--cover-sub", ARGS.cover_sub, "--cover-jitter", ARGS.cover_jitter,
            "--seed", seed)))
    songs, test, seconds = z["cal"]
    for sub, seed in ((10, 61), (25, 62), (45, 63)):
        background.append(start("corpus_cal_sub%d" % sub, corpus(
            "out/cal_sub%d" % sub, "--train-songs", 0, "--val-songs", 0, "--db-songs", songs,
            "--test-songs", test, "--seconds", seconds, "--family-size", 4, "--cover-frac",
            "1.0", "--cover-sub", "0.%d" % sub, "--cover-jitter", "0.06", "--seed", seed)))
    run("corpus_synth_big", corpus("out/synth_big", *z["synth_big"], "--db-songs", 0,
                                   "--test-songs", 0, "--seed", 5))
    os.makedirs(os.path.join(root, "configs"), exist_ok=True)
    cfg_path = "configs/flagship.json"
    shutil.copy(os.path.join(REPO, cfg_path), os.path.join(root, cfg_path))
    if ARGS.epochs:
        with open(os.path.join(REPO, cfg_path)) as f:
            cfg = json.load(f)
        cfg["epoch"] = ARGS.epochs
        cfg_path = "configs/flagship_epoch%d.json" % ARGS.epochs
        with open(os.path.join(root, cfg_path), "w") as f:
            json.dump(cfg, f, indent=2)
    run("train_flagship", port("train", "-p", cfg_path, "-w", 2, *dev))
    shutil.copy(os.path.join(root, "out", "models", "flagship", "metrics.jsonl"),
                os.path.join(ARGS.out, "flagship_metrics.jsonl"))
    for job in background:
        wait(job)
    os.makedirs(os.path.join(root, "out", "lists"), exist_ok=True)
    with open(os.path.join(root, "out", "lists", "flagship_30kbase.txt"), "w") as f:
        for c in ("synth_dataset", "synth30k_distract"):
            with open(os.path.join(root, "out", c, "lists", "db.txt")) as src:
                f.write(src.read())
    run("build_flagship_30kbase", port("builder", "out/lists/flagship_30kbase.txt",
                                       "out/dbs/flagship_30kbase", "out/models/flagship", *dev))
    lines_of("build_flagship_30kbase", ("build stats",))
    run("r05_calibrate", port("tools.r05_calibrate", *dev, *jobs), env=z["nq"])
    lines_of("r05_calibrate", ("cover_sub=", "exact", "near", "song", "CALIBRATE"))
    run("r05_flagship", port("tools.r05_flagship", *dev, *jobs),
        env={"COVER_SUB": ARGS.cover_sub, "COVER_JITTER": ARGS.cover_jitter} | z["nq"])
    lines_of("r05_flagship", ("set=", "exact", "near", "song", "R05_"))
    fallback = set()
    for path in glob.glob(os.path.join(root, "logs", "nnmatcher-*.log")):
        with open(path) as f:
            fallback |= {ln.split("] ", 2)[-1].strip() for ln in f if "topk fallback" in ln}
    print("  r05_flagship| the matcher's fallback log lines: %s" % sorted(fallback), flush=True)
    audit()


def main() -> None:
    global ARGS, DB_SONGS, DISTRACT, R05_SIZES
    ap = argparse.ArgumentParser()
    ap.add_argument("recipe", choices=("r04", "r05"))
    ap.add_argument("--root", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--jobs", default="8")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--cover-sub", default="0.03")
    ap.add_argument("--cover-jitter", default="0.02")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true")
    ARGS = ap.parse_args()
    if ARGS.tiny:
        DB_SONGS, DISTRACT, R05_SIZES = 3, (4, 3), TINY_R05
    ARGS.root, ARGS.out = os.path.realpath(ARGS.root), os.path.realpath(ARGS.out)
    os.makedirs(ARGS.root, exist_ok=True)
    os.makedirs(ARGS.out, exist_ok=True)
    print(card(), flush=True)
    print(shutil.disk_usage(ARGS.root), flush=True)
    t0 = time.perf_counter()
    (r04 if ARGS.recipe == "r04" else r05)()
    print("%s wall %.1f s  [%s]" % (ARGS.recipe, time.perf_counter() - t0, card()), flush=True)


if __name__ == "__main__":
    main()
