"""Round-4 phase 3 on the port: the rescued screen across every SNR, then
the report.

    python -m pfann_tpu_torch.tools.r04_rescue [--device cuda|cpu] [--jobs N]

The port of ``tools/r04_rescue.sh``, run after ``r04_pipeline`` from the
same working directory: the ``rescued`` variant (``{"screen": true,
"screen_rescue": 0.4}``, the production default) through
``tools/make_variant_db.py``; per SNR ``matchemb --batch 128``, then per
SNR ``tools/accuracy.py``; ``bench --db`` on the variant into
``BENCH_r04_db_rescued.json``; then ``tools/r04_report.py``, which writes
``ACCURACY_r04.md`` into the working directory.  Every port CLI gets
``--device`` (default cuda, which raises where no card is visible); a
failing step stops the driver with its exit code.  ``--jobs N`` runs the
per-SNR matches N at a time.  The script's
``PFANN_COMPILE_CACHE`` export has no counterpart (see ``r04_pipeline``).
"""

from __future__ import annotations

import sys

from pfann_tpu_torch.tools.r04_pipeline import accuracy, bench_db, make_variant, matchemb
from pfann_tpu_torch.utils.device import pop_device_flag, resolve_device
from pfann_tpu_torch.utils.harness import SNRS, check, check_all, host_tool, pop_jobs_flag, stamp


def main(argv: list[str] | None = None) -> None:
    argv = list(sys.argv if argv is None else argv)
    device = pop_device_flag(argv)
    jobs = pop_jobs_flag(argv)
    resolve_device(device)
    # force the screen engine: below the auto threshold (30k songs) the DB
    # would serve the exhaustive engine, and the rescue table would compare
    # the control with itself
    make_variant("rescued", '{"screen": true, "screen_rescue": 0.4}')
    stamp("rescued, every snr")
    check_all([matchemb("rescued", snr, device) for snr in SNRS], jobs=jobs)
    for snr in SNRS:
        accuracy("rescued", snr)

    stamp("db throughput with rescue (worst-case noisy mix)")
    bench_db("out/dbs/rescued_synth", "BENCH_r04_db_rescued.json", device)

    stamp("report")
    check(host_tool("tools/r04_report.py"))
    stamp("done")


if __name__ == "__main__":
    main()
