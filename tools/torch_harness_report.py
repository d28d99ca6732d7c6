#!/usr/bin/env python
"""Per SNR, what the port's round-4 screen validation did: the share of
queries the rescued screen escalated to stage 3, and how many of its
answers equal the exhaustive control's.

    python tools/torch_harness_report.py <root> [--device cuda|cpu]

``<root>`` is the working directory of a finished ``python -m
pfann_tpu_torch.tools.r04_pipeline`` / ``r04_rescue`` run.  The rescued
variant (``out/dbs/rescued_synth``) serves each SNR's query embeddings
(``out/qemb/synth_snr*``) 128 a call, as ``matchemb --batch 128`` does,
and its engine's ``escalated`` count is read around each set; the
results' ``_detail.csv`` files give the rescued, forced-screen
(``screenforce``) and ``alignctl`` answers (ids and times).
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pfann_tpu_torch.index.database import Database  # noqa: E402
from pfann_tpu_torch.utils.device import resolve_device  # noqa: E402

SNRS = (-6, -4, -2, 0, 2, 4, 6, 8)


def answers(root: str, tag: str, snr: int) -> list[tuple[str, str, str]]:
    path = os.path.join(root, "out", "results", "%s_synth_snr%d_detail.csv" % (tag, snr))
    with open(path) as f:
        return [(r["query"], r["answer"], r["time"]) for r in csv.DictReader(f)]


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("root")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    db_dir = os.path.join(args.root, "out", "dbs", "rescued_synth")
    with open(os.path.join(db_dir, "configs.json")) as f:
        params = json.load(f)
    db = Database(db_dir, params["indexer"], params["hop_size"], device)
    d = params["model"]["d"]
    for snr in SNRS:
        qdir = os.path.join(args.root, "out", "qemb", "synth_snr%d" % snr)
        emb = np.fromfile(os.path.join(qdir, "query_embeddings"), np.float32).reshape(-1, d)
        idx = np.fromfile(os.path.join(qdir, "query_index"), np.int64).reshape(-1, 2)
        queries = [emb[a : a + n] for a, n in idx]
        before = db._align.escalated
        for at in range(0, len(queries), 128):
            db.query_embeddings_batch(queries[at : at + 128])
        escalated = db._align.escalated - before
        rescued, control, forced = (answers(args.root, t, snr)
                                    for t in ("rescued", "alignctl", "screenforce"))
        print("snr %+d: %d queries, escalated %d (%.4f), rescued == alignctl %d/%d, "
              "screenforce == alignctl %d/%d"
              % (snr, len(queries), escalated, escalated / max(len(queries), 1),
                 sum(a == b for a, b in zip(rescued, control)), len(control),
                 sum(a == b for a, b in zip(forced, control)), len(control)), flush=True)


if __name__ == "__main__":
    main()
