"""The resume of ``r04_scale30k`` after an interruption, on the port.

    python -m pfann_tpu_torch.tools.r04_scale30k_resume [--device cuda|cpu] [--jobs N]

The port of ``tools/r04_scale30k_resume.sh``, step for step, from the
working directory of an ``r04_scale30k`` run that built and merged
``out/dbs/synth30k`` and ``out/dbs/alignctl30k`` and matched the auto
engine from -6 to +2 dB: one ``matchemb --batch 128 --pairs`` process for
the auto engine at 4, 6 and 8 dB, one for the align control at every
SNR, ``tools/accuracy.py`` per tag and SNR, and ``bench --db
out/dbs/synth30k``'s last line into ``BENCH_r04_db30k.json``.  Every port
CLI gets ``--device`` (default cuda, which raises where no card is
visible); a failing step stops the driver with its exit code.  ``--jobs
2`` (or more) runs the two matchemb processes at once.  The script's
``PFANN_COMPILE_CACHE`` export has no counterpart (see ``r04_scale30k``).
"""

from __future__ import annotations

import sys

from pfann_tpu_torch.tools.r04_scale30k import (
    CONTROL,
    DB,
    accuracy,
    bench30k,
    match,
    matchemb_pairs,
)
from pfann_tpu_torch.utils.device import pop_device_flag, resolve_device
from pfann_tpu_torch.utils.harness import SNRS, pop_jobs_flag, stamp


def main(argv: list[str] | None = None) -> None:
    argv = list(sys.argv if argv is None else argv)
    device = pop_device_flag(argv)
    jobs = pop_jobs_flag(argv)
    resolve_device(device)
    match([("finish auto engine SNR 4 6 8", matchemb_pairs(DB, "synth30k", (4, 6, 8), device)),
           ("match align control per SNR",
            matchemb_pairs(CONTROL, "alignctl30k", SNRS, device))], jobs)
    stamp("accuracy")
    accuracy()
    bench30k(device)


if __name__ == "__main__":
    main()
