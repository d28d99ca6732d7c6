"""The round-5 difficulty calibration on the port: song top-1 of the
flagship model at three cover substitution rates.

    [NQ=200] python -m pfann_tpu_torch.tools.r05_calibrate [--device cuda|cpu] [--jobs N]

The port of ``tools/r05_calibrate.sh``, step for step, from the working
directory, which must hold ``out/models/flagship`` (trained),
``out/dbs/flagship_30kbase`` (the flagship's embeddings of the 30k
distractor DB) and the corpora ``out/cal_sub{10,25,45}``
(``make_synth_corpus --cover-frac 1.0 --cover-sub 0.N``):
  shard     the three corpora's ``lists/db.txt`` concatenated into
            ``out/lists/cal_all_db.txt``, ``builder`` into
            ``out/dbs/cal_shard``, and ``tools.merge_dbs`` of
            ``flagship_30kbase`` and the shard into ``out/dbs/flagship_cal``
  queries   per corpus ``tools/mk_gentest.py <root> gentest_cal<sub>
            --model flagship --snrs=-6,0`` (it writes
            ``configs/gentest_cal<sub>_snr<S>.json`` under the working
            directory), then per SNR ``genquery --len 10 --num $NQ --mode
            test --yes`` into ``out/queries/cal<sub>_snr<S>``
  match     one ``matcher --pairs --batch 128`` process over the six sets
  accuracy  ``tools/accuracy.py`` per set, each after its
            ``cover_sub=0.<sub> snr=<S>`` line
then ``CALIBRATE_DONE``.  ``NQ`` is read as the script reads it (200
where unset or empty).  Each step is echoed to stderr first, as the
script's ``set -x`` does; a failing step stops the driver with its exit
code.  Every port CLI that touches the model gets ``--device`` (default
cuda, which raises where no card is visible); ``--jobs N`` runs the six
genquery steps N at once, after the three mk_gentest steps (without it,
the script's order: each corpus' configs, then its two sets).  One
departure, kept on purpose: the script writes its list to
``/tmp/cal_all_db.txt``, which two runs at once would share; the driver
writes it under the working directory.
"""

from __future__ import annotations

import sys

from pfann_tpu_torch.utils.device import pop_device_flag, resolve_device
from pfann_tpu_torch.utils.harness import (
    check,
    check_all,
    concat,
    env_or,
    host_tool,
    pop_jobs_flag,
    port,
)

SUBS = (10, 25, 45)
CAL_SNRS = (-6, 0)
CAL_LIST = "out/lists/cal_all_db.txt"


def genquery(params: str, length: int, num: str, out: str) -> list[str]:
    return port("genquery", "--params", params, "--len", length, "--num", num,
                "--mode", "test", "--out", out, "--yes")


def main(argv: list[str] | None = None) -> None:
    argv = list(sys.argv if argv is None else argv)
    device = pop_device_flag(argv)
    jobs = pop_jobs_flag(argv)
    resolve_device(device)
    nq = env_or("NQ", "200")
    dev = ("--device", device)

    concat(["out/cal_sub%d/lists/db.txt" % sub for sub in SUBS], CAL_LIST)
    check(port("builder", CAL_LIST, "out/dbs/cal_shard", "out/models/flagship", *dev),
          echo=True)
    check(port("tools.merge_dbs", "out/dbs/flagship_cal", "out/dbs/flagship_30kbase",
               "out/dbs/cal_shard"), echo=True)

    queries, pairs = [], []
    for sub in SUBS:
        check(host_tool("tools/mk_gentest.py", "out/cal_sub%d" % sub, "gentest_cal%d" % sub,
                        "--model", "flagship", "--snrs=-6,0"), echo=True)
        for snr in CAL_SNRS:
            out = "out/queries/cal%d_snr%d" % (sub, snr)
            queries.append(genquery("configs/gentest_cal%d_snr%d.json" % (sub, snr), 10, nq,
                                    out))
            pairs += [out + "/list.txt", "out/results/cal%d_snr%d.txt" % (sub, snr)]
            if jobs <= 1:
                check(queries[-1], echo=True)
    if jobs > 1:
        check_all(queries, jobs=jobs, echo=True)

    check(port("matcher", "--pairs", "--batch", 128, "out/dbs/flagship_cal", *pairs, *dev),
          echo=True)

    for sub in SUBS:
        for snr in CAL_SNRS:
            print("cover_sub=0.%d snr=%d" % (sub, snr), flush=True)
            check(host_tool("tools/accuracy.py", "out/queries/cal%d_snr%d/expected.csv"
                            % (sub, snr), "out/results/cal%d_snr%d_detail.csv" % (sub, snr)),
                  echo=True)
    print("CALIBRATE_DONE", flush=True)


if __name__ == "__main__":
    main()
