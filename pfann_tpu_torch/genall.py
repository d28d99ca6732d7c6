"""Generate the per-SNR query test sets with the port's genquery.

    python -m pfann_tpu_torch.genall [config_prefix] [out_prefix] \
        [num_queries] [len_seconds] [--jobs N]

The port of ``genall.sh``, with its argv and defaults (gentest configs,
out2 sets, 2,000 x 10 s queries per SNR): for each SNR in -6 ... 8 it runs
``python -m pfann_tpu_torch.genquery --params
configs/<prefix>_snr<snr>.json --length <len> --num <num> --mode test
--out out/queries/<out>_snr<snr> --yes`` from the working directory, and
exits 1 at the first that fails.  genquery is numpy on the host, so this
driver takes no ``--device``.  Synthetic-data run (after
``python -m pfann_tpu_torch.tools.make_synth_corpus``):

    python -m pfann_tpu_torch.genall gentest_synth synth 200 10
"""

from __future__ import annotations

import sys

from pfann_tpu_torch.utils.harness import SNRS, check_all, pop_jobs_flag, port

DEFAULTS = ("gentest", "out2", "2000", "10")


def main(argv: list[str] | None = None) -> None:
    args = list(sys.argv if argv is None else argv)[1:]
    jobs = pop_jobs_flag(args)
    prefix, out, num, length = args[: len(DEFAULTS)] + list(DEFAULTS[len(args):])
    check_all([port("genquery", "--params", "configs/%s_snr%d.json" % (prefix, snr),
                    "--length", length, "--num", num, "--mode", "test",
                    "--out", "out/queries/%s_snr%d" % (out, snr), "--yes")
               for snr in SNRS], jobs=jobs, code=1)


if __name__ == "__main__":
    main()
