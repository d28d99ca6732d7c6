"""The round-5 flagship evaluation on the port: per-SNR accuracy of the
flagship model at 10 s and 60 s over the cover-calibrated eval set and
the 30k distractor mass.

    COVER_SUB=0.NN [NQ10=2000] [NQ60=400] [COVER_JITTER=0.06] \
        [R5_ROOT=out/synth_r5] [R5M_ROOT=out/synth_r5m] \
        python -m pfann_tpu_torch.tools.r05_flagship [--device cuda|cpu] [--jobs N]

The port of ``tools/r05_flagship.sh``, step for step, from the working
directory, which must hold ``out/models/flagship`` (trained) and
``out/dbs/flagship_30kbase`` (the flagship's embeddings of the 30k
distractor DB):
  corpora   unless its ``lists/db.txt`` is there, ``make_synth_corpus``
            writes ``$R5_ROOT`` (1,500 DB + 500 test tracks of 30 s, seed
            71) and ``$R5M_ROOT`` (120 + 40 tracks of 90 s, seed 72), both
            family size 4, every song a cover (``--cover-frac 1.0``) at
            ``$COVER_SUB`` and ``$COVER_JITTER``
  configs   ``tools/mk_gentest.py`` for each (``gentest_r5``,
            ``gentest_r5m``, ``--model flagship``), which writes
            ``configs/gentest_r5{,m}_snr<S>.json`` under the working
            directory
  shard     the two ``lists/db.txt`` concatenated into
            ``out/lists/r5_shard.txt``, ``builder`` into
            ``out/dbs/r5_shard``, ``tools.merge_dbs`` of
            ``flagship_30kbase`` and the shard into ``out/dbs/flagship_r5``
  queries   per SNR ``genquery --len 10 --num $NQ10`` from ``$R5_ROOT``
            (``out/queries/r5_snr<S>``) and ``--len 60 --num $NQ60`` from
            ``$R5M_ROOT`` (``out/queries/r5m_snr<S>``)
  match     one ``matcher --pairs --batch 128`` process over the 16 sets
  accuracy  ``tools/accuracy.py`` per set, each after its ``set=<r5|r5m>
            snr=<S>`` line
then ``R05_PIPELINE_DONE``.  The variables are read as the script reads
them: ``COVER_SUB`` is required, and where it is unset or empty the
driver exits 1 with the script's message before any step; the others
take the script's defaults where unset or empty.  Each step is echoed to
stderr first (``set -x``); a failing step stops the driver with its exit
code.  Every port CLI that touches the model gets ``--device`` (default
cuda, which raises where no card is visible); ``--jobs N`` runs the 16
genquery steps N at once.  One departure, kept on purpose: the script
writes its list to ``/tmp/r5_shard.txt``, which two runs at once would
share; the driver writes it under the working directory.
"""

from __future__ import annotations

import os
import sys

from pfann_tpu_torch.tools.r05_calibrate import genquery
from pfann_tpu_torch.utils.device import pop_device_flag, resolve_device
from pfann_tpu_torch.utils.harness import (
    SNRS,
    check,
    check_all,
    concat,
    env_or,
    host_tool,
    pop_jobs_flag,
    port,
)

SHARD_LIST = "out/lists/r5_shard.txt"
# set, its root's variable and default; the corpus' DB and test songs, their
# seconds and its seed; the queries' seconds, their count's variable and default
SETS = (("r5", "R5_ROOT", "out/synth_r5", 1500, 500, 30, 71, 10, "NQ10", "2000"),
        ("r5m", "R5M_ROOT", "out/synth_r5m", 120, 40, 90, 72, 60, "NQ60", "400"))


def main(argv: list[str] | None = None) -> None:
    argv = list(sys.argv if argv is None else argv)
    device = pop_device_flag(argv)
    jobs = pop_jobs_flag(argv)
    resolve_device(device)
    cover_sub = os.environ.get("COVER_SUB")
    if not cover_sub:
        raise SystemExit("COVER_SUB: set COVER_SUB=0.NN from tools/r05_calibrate.sh")
    jitter = env_or("COVER_JITTER", "0.06")
    roots = {name: env_or(var, default) for name, var, default, *_ in SETS}
    dev = ("--device", device)

    for name, _, _, songs, test, seconds, seed, *_ in SETS:
        if not os.path.isfile(os.path.join(roots[name], "lists", "db.txt")):
            check(port("tools.make_synth_corpus", "--root", roots[name], "--train-songs", 0,
                       "--val-songs", 0, "--db-songs", songs, "--test-songs", test,
                       "--seconds", seconds, "--family-size", 4, "--cover-frac", "1.0",
                       "--cover-sub", cover_sub, "--cover-jitter", jitter, "--seed", seed),
                  echo=True)
    for name, *_ in SETS:
        check(host_tool("tools/mk_gentest.py", roots[name], "gentest_" + name, "--model",
                        "flagship"), echo=True)

    concat([os.path.join(roots[name], "lists", "db.txt") for name, *_ in SETS], SHARD_LIST)
    check(port("builder", SHARD_LIST, "out/dbs/r5_shard", "out/models/flagship", *dev),
          echo=True)
    check(port("tools.merge_dbs", "out/dbs/flagship_r5", "out/dbs/flagship_30kbase",
               "out/dbs/r5_shard"), echo=True)

    queries, pairs = [], []
    for snr in SNRS:
        for name, _, _, _, _, _, _, length, count, default in SETS:
            out = "out/queries/%s_snr%d" % (name, snr)
            queries.append(genquery("configs/gentest_%s_snr%d.json" % (name, snr), length,
                                    env_or(count, default), out))
            pairs += [out + "/list.txt", "out/results/flagship_%s_snr%d.txt" % (name, snr)]
    check_all(queries, jobs=jobs, echo=True)

    check(port("matcher", "--pairs", "--batch", 128, "out/dbs/flagship_r5", *pairs, *dev),
          echo=True)

    for name, *_ in SETS:
        for snr in SNRS:
            print("set=%s snr=%d" % (name, snr), flush=True)
            check(host_tool("tools/accuracy.py", "out/queries/%s_snr%d/expected.csv"
                            % (name, snr), "out/results/flagship_%s_snr%d_detail.csv"
                            % (name, snr)), echo=True)
    print("R05_PIPELINE_DONE", flush=True)


if __name__ == "__main__":
    main()
