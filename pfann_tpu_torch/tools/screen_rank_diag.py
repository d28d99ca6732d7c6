"""Coarse-stage rank diagnostic for the screened engine, on the port.

For every query in an extracted-embeddings dir (extractemb output),
compute the ground-truth song's RANK under the screen's stage-1 coarse
score (index/screen.py ``coarse_scores``, with the full [B, n_songs]
scores instead of the top-M cut).  The rank distribution IS the
recall-vs-screen_top_m curve: recall@M = P(rank < M), so one run tells
the top_m a target recall needs on real embeddings.

    python -m pfann_tpu_torch.tools.screen_rank_diag <qemb_dir> <db_dir> \
        <expected.csv> [--pool-k 4] [--int8] [--batch 64] [--pad 32] \
        [--device cuda|cpu]

Prints the same JSON line as the JAX ``tools/screen_rank_diag.py``.  Stage
1 runs on ``--device`` (default cuda, which raises where no card is
visible): the align-reduce kernel there, its plain version on the CPU.
"""

import argparse
import csv
import json
import os

import numpy as np
import torch

from pfann_tpu_torch.index.screen import build_screen_layout, coarse_scores, quantize_coarse_int8
from pfann_tpu_torch.utils.config import read_file_list
from pfann_tpu_torch.utils.device import resolve_device


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("qemb_dir")
    ap.add_argument("db_dir")
    ap.add_argument("expected")
    ap.add_argument("--pool-k", type=int, default=4)
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--pad", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(None if argv is None else argv[1:])
    device = resolve_device(args.device)

    names = read_file_list(os.path.join(args.qemb_dir, "queryList.txt"))
    idx = np.fromfile(os.path.join(args.qemb_dir, "query_index"), np.int64).reshape(-1, 2)

    songs = [os.path.basename(s) for s in
             read_file_list(os.path.join(args.db_dir, "songList.txt"))]
    song_id = {s: i for i, s in enumerate(songs)}
    counts = np.fromfile(os.path.join(args.db_dir, "landmarkKey"), np.int32)
    with open(os.path.join(args.db_dir, "index_meta.json")) as f:
        d = int(json.load(f).get("d", 128))
    emb = np.fromfile(os.path.join(args.qemb_dir, "query_embeddings"), np.float32).reshape(-1, d)
    demb = np.fromfile(os.path.join(args.db_dir, "embeddings"), np.float32).reshape(-1, d)

    with open(args.expected) as f:
        gt = {row["query"]: os.path.basename(row["answer"]) for row in csv.DictReader(f)}

    k = args.pool_k
    _, coarse, _, Rc, n_pad = build_screen_layout(demb, counts, pad=args.pad, k=k, d=d)
    if args.int8:
        coarse = quantize_coarse_int8(coarse)
    coarse_dev = torch.from_numpy(coarse).to(device)
    n_songs = len(counts)
    # uniform query windows (extractemb output for fixed-length queries)
    S = int(idx[:, 1].max())
    invalid = (torch.arange(n_pad, device=device) >= n_songs)[None, :]

    ranks, skipped = [], 0
    batch_q, batch_g = [], []

    def run():
        nonlocal batch_q, batch_g
        if not batch_q:
            return
        qpad = np.zeros((len(batch_q), S, d), np.float32)
        for i, q in enumerate(batch_q):
            qpad[i, : q.shape[0]] = q
        best = coarse_scores(coarse_dev, torch.from_numpy(qpad).to(device), k=k, Rc=Rc,
                             n_pad=n_pad).float()
        best = best.masked_fill(invalid, float("-inf"))
        gt_ids = torch.tensor(batch_g, device=device)
        gt_score = best.gather(1, gt_ids[:, None])
        ranks.extend((best > gt_score).sum(dim=1).tolist())
        batch_q, batch_g = [], []

    for name, (start, ln) in zip(names, idx):
        ans = gt.get(os.path.basename(name))
        if ln <= 0 or ans not in song_id:
            skipped += 1
            continue
        batch_q.append(emb[start : start + ln])
        batch_g.append(song_id[ans])
        if len(batch_q) == args.batch:
            run()
    run()

    ranks = np.asarray(ranks)
    pct = {p: int(np.percentile(ranks, p)) for p in (50, 90, 95, 99, 99.9)}
    out = {
        "n": len(ranks),
        "skipped": skipped,
        "pool_k": k,
        "int8": bool(args.int8),
        "rank_percentiles": pct,
        "recall_at_M": {
            M: round(float((ranks < M).mean()), 4)
            for M in (32, 64, 128, 256, 512, 1024, 2048)
        },
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
