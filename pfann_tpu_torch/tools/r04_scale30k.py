"""The round-4 screen at its auto-activation scale on the port: the
synthetic DB grown by distractor songs to 30,000 tracks.

    python -m pfann_tpu_torch.tools.r04_scale30k [--distract-songs 9970] \
        [--seconds 60] [--device cuda|cpu] [--jobs N]

The port of ``tools/r04_scale30k.sh``, step for step, from the working
directory (which must hold ``out/models/synth``, ``out/dbs/synth_synth``,
the query sets ``out/queries/synth_snr*`` and their embeddings
``out/qemb/synth_snr*``, as ``run_synth_pipeline`` and ``r04_pipeline``
leave them):
  distractors  unless ``out/synth30k_distract/lists/db.txt`` is there,
               ``python -m pfann_tpu_torch.tools.make_synth_corpus`` writes
               ``--distract-songs`` DB songs of ``--seconds`` s (seed 777,
               no train, validation or test songs)
  shard        unless its ``embeddings`` are there, ``builder`` builds
               ``out/dbs/distract10k`` with ``out/models/synth``
  merge        ``tools.merge_dbs`` into ``out/dbs/synth30k``, and
               ``tools/make_variant_db.py`` makes ``out/dbs/alignctl30k``
               (``{"screen": false}``)
  match        one ``matchemb --batch 128 --pairs`` process for all eight
               SNR sets on each DB (``synth30k``: the engine the DB picks,
               the screen at 30,000 songs and more; ``alignctl30k``: the
               exhaustive control)
  accuracy     ``tools/accuracy.py`` per tag and SNR, each after its
               ``model=<tag> snr=<S>`` line
  bench        ``bench --db out/dbs/synth30k``'s last line into
               ``BENCH_r04_db30k.json`` in the working directory
The script's sizes are the flags' defaults: 9,970 distractors make the
20,030-track DB of round 4 30,000 tracks.  Every port CLI gets
``--device`` (default cuda, which raises where no card is visible); a
failing step stops the driver with its exit code, the bench included.
``--jobs 2`` (or more) runs the two matchemb processes at once.  The
script's ``PFANN_COMPILE_CACHE`` export (a persistent cache of JAX
compiles) has no counterpart: the port's kernel library is built once
into ``pfann_tpu_torch/_build/`` and every later process loads it.
"""

from __future__ import annotations

import argparse
import os

from pfann_tpu_torch.tools.r04_pipeline import bench_db
from pfann_tpu_torch.utils.device import resolve_device
from pfann_tpu_torch.utils.harness import (
    SNRS,
    check,
    check_all,
    host_tool,
    port,
    stamp,
)

DISTRACT_ROOT = "out/synth30k_distract"
SHARD = "out/dbs/distract10k"
DB = "out/dbs/synth30k"
CONTROL = "out/dbs/alignctl30k"
TAGS = ((DB, "synth30k"), (CONTROL, "alignctl30k"))
SEED = 777


def parse_args(argv: list[str] | None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m pfann_tpu_torch.tools.r04_scale30k")
    ap.add_argument("--distract-songs", type=int, default=9970)
    ap.add_argument("--seconds", type=float, default=60)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--jobs", type=int, default=1, help="matchemb processes at once")
    return ap.parse_args(argv)


def distractor_corpus(songs: int, seconds: float) -> list[str]:
    """The step that writes the distractor corpus."""
    return port("tools.make_synth_corpus", "--root", DISTRACT_ROOT, "--train-songs", 0,
                "--val-songs", 0, "--test-songs", 0, "--db-songs", songs,
                "--seconds", "%g" % seconds, "--seed", SEED)


def matchemb_pairs(db: str, tag: str, snrs, device: str) -> list[str]:
    """One matchemb process over the SNR sets ``snrs``: one DB load."""
    pairs = []
    for snr in snrs:
        pairs += ["out/qemb/synth_snr%d" % snr, "out/results/%s_snr%d.txt" % (tag, snr)]
    return port("matchemb", "--batch", 128, "--pairs", db, *pairs, "--device", device)


def match(steps: list[tuple[str, list[str]]], jobs: int) -> None:
    """(message, matchemb command) steps, each after its ``stamp``; with
    ``jobs`` > 1 all at once, after all their messages."""
    if jobs <= 1:
        for message, cmd in steps:
            stamp(message)
            check(cmd)
        return
    for message, _ in steps:
        stamp(message)
    check_all([cmd for _, cmd in steps], jobs=jobs)


def accuracy() -> None:
    for _, tag in TAGS:
        for snr in SNRS:
            print("model=%s snr=%d" % (tag, snr), flush=True)
            check(host_tool("tools/accuracy.py", "out/queries/synth_snr%d/expected.csv" % snr,
                            "out/results/%s_snr%d_detail.csv" % (tag, snr)))


def bench30k(device: str) -> None:
    stamp("db throughput artifact at 30k")
    bench_db(DB, "BENCH_r04_db30k.json", device)
    stamp("done")


def main(argv: list[str] | None = None) -> None:
    args = parse_args(argv)
    resolve_device(args.device)
    os.makedirs("out/results", exist_ok=True)

    if not os.path.isfile(os.path.join(DISTRACT_ROOT, "lists", "db.txt")):
        stamp("generate %s distractor songs" % format(args.distract_songs, ","))
        check(distractor_corpus(args.distract_songs, args.seconds))

    if not os.path.isfile(os.path.join(SHARD, "embeddings")):
        stamp("build distractor shard")
        check(port("builder", os.path.join(DISTRACT_ROOT, "lists", "db.txt"), SHARD,
                   "out/models/synth", "--device", args.device))

    stamp("merge into the 30k DB")
    check(port("tools.merge_dbs", DB, "out/dbs/synth_synth", SHARD))
    check(host_tool("tools/make_variant_db.py", DB, CONTROL, '{"screen": false}'))

    match([("match auto engine per SNR - one DB load for all sweeps",
            matchemb_pairs(DB, "synth30k", SNRS, args.device)),
           ("match align control per SNR",
            matchemb_pairs(CONTROL, "alignctl30k", SNRS, args.device))], args.jobs)

    stamp("accuracy")
    accuracy()
    bench30k(args.device)


if __name__ == "__main__":
    main()
