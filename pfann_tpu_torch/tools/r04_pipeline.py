"""The round-4 screened-engine validation on the port.

    python -m pfann_tpu_torch.tools.r04_pipeline [--device cuda|cpu] [--jobs N]

The port of ``tools/r04_pipeline.sh``, step for step, from the working
directory (which must hold ``out/models/synth`` and the query sets
``out/queries/synth_snr*``, as ``run_synth_pipeline`` leaves them):
build ``out/dbs/synth_synth`` if its ``embeddings`` are missing; make the
variant DBs with ``tools/make_variant_db.py`` (``alignctl``: exhaustive
control; ``screen8``, ``screenm16``, ``screeni8``: screen tuning;
``screenforce``: the screen forced on); extract each SNR set's query
embeddings once (``python -m pfann_tpu_torch.extractemb``); match them
with ``matchemb --batch 128`` on ``screenforce`` and ``alignctl``, score
them with ``tools/accuracy.py``, then the three tuning variants at -6 dB
(their matches, then their accuracy lines);
and write ``python -m pfann_tpu_torch.bench --db``'s last line for the
base DB and for ``screenforce`` into ``BENCH_r04_db.json`` and
``BENCH_r04_db_rescued.json`` in the working directory.  Every port CLI
gets ``--device`` (default cuda, which raises where no card is visible).
A failing step stops the driver with its exit code, the bench included
(the script's ``| tail -1 | tee`` hides a failing bench).  ``--jobs N``
runs the per-SNR extractions, each engine's per-SNR matches and the
tuning variants' matches N at a time.  The script's
``PFANN_COMPILE_CACHE`` export (a persistent cache of JAX compiles) has
no counterpart: the port's kernel library is built once into
``pfann_tpu_torch/_build/`` and every later process loads it.
"""

from __future__ import annotations

import os
import sys

from pfann_tpu_torch.utils.device import pop_device_flag, resolve_device
from pfann_tpu_torch.utils.harness import (
    SNRS,
    check,
    check_all,
    host_tool,
    pop_jobs_flag,
    port,
    stamp,
    tee_last_line,
)

BASE_DB = "out/dbs/synth_synth"
VARIANTS = (
    ("alignctl", '{"screen": false}'),
    ("screen8", '{"screen": true, "screen_pool_k": 8}'),
    ("screenm16", '{"screen": true, "screen_top_m": 16}'),
    ("screeni8", '{"screen": true, "screen_coarse_dtype": "int8"}'),
)
TUNING = ("screen8", "screenm16", "screeni8")


def make_variant(tag: str, overrides: str) -> None:
    check(host_tool("tools/make_variant_db.py", BASE_DB, "out/dbs/%s_synth" % tag, overrides))


def matchemb(tag: str, snr: int, device: str) -> list[str]:
    return port("matchemb", "--batch", 128, "out/qemb/synth_snr%d" % snr,
                "out/dbs/%s_synth" % tag, "out/results/%s_synth_snr%d.txt" % (tag, snr),
                "--device", device)


def accuracy(tag: str, snr: int) -> None:
    check(host_tool("tools/accuracy.py", "out/queries/synth_snr%d/expected.csv" % snr,
                    "out/results/%s_synth_snr%d_detail.csv" % (tag, snr)))


def bench_db(db: str, out: str, device: str) -> None:
    """``bench --db <db> | tail -1 | tee <out>``."""
    tee_last_line(port("bench", "--db", db, "--device", device), out)


def main(argv: list[str] | None = None) -> None:
    argv = list(sys.argv if argv is None else argv)
    device = pop_device_flag(argv)
    jobs = pop_jobs_flag(argv)
    resolve_device(device)
    for d in ("out/dbs", "out/results", "out/qemb"):
        os.makedirs(d, exist_ok=True)

    if not os.path.isfile(os.path.join(BASE_DB, "embeddings")):
        stamp("build DB")
        check(port("builder", "out/synth_dataset/lists/db.txt", BASE_DB, "out/models/synth",
                   "--device", device))

    stamp("make align-control + screen-tuning variants")
    for tag, overrides in VARIANTS:
        make_variant(tag, overrides)

    stamp("extract query embeddings once per SNR set")
    check_all([port("extractemb", "out/queries/synth_snr%d/list.txt" % snr, BASE_DB,
                    "out/qemb/synth_snr%d" % snr, "--device", device) for snr in SNRS
               if not os.path.isfile("out/qemb/synth_snr%d/query_embeddings" % snr)], jobs=jobs)

    stamp("make the screen-forced primary variant")
    make_variant("screenforce", '{"screen": true}')
    stamp("match screen engine")
    check_all([matchemb("screenforce", snr, device) for snr in SNRS], jobs=jobs)
    stamp("match align control")
    check_all([matchemb("alignctl", snr, device) for snr in SNRS], jobs=jobs)

    stamp("accuracy")
    for tag in ("screenforce", "alignctl"):
        for snr in SNRS:
            print("model=%s snr=%d" % (tag, snr), flush=True)
            accuracy(tag, snr)

    stamp("tuning variants on the worst SNR only")
    check_all([matchemb(tag, -6, device) for tag in TUNING], jobs=jobs)
    for tag in TUNING:
        print("model=%s snr=-6" % tag, flush=True)
        accuracy(tag, -6)

    stamp("db throughput artifact")
    bench_db(BASE_DB, "BENCH_r04_db.json", device)
    bench_db("out/dbs/screenforce_synth", "BENCH_r04_db_rescued.json", device)
    stamp("done")


if __name__ == "__main__":
    main()
