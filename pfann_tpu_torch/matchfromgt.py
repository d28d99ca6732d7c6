"""Oracle diagnostic: score each query against its ground-truth song only,
on the port.

    python -m pfann_tpu_torch.matchfromgt <file list> <gt tsv> <db dir> \
        <result csv> [--device cuda|cpu]

Same argv and CSV as the JAX ``matchfromgt.py``: for every query with
ground truth, the best full dot-product alignment offset against the
correct song (no index involved: embedding quality apart from retrieval)
and, per aligned segment, the rank of the true DB vector among the whole
database.  Row: query, answer, summed score, time, then triples (segment
score, query row index, rank).  The embedder runs on ``--device``
(default cuda; raises if no card is visible); the alignment and ranks
are host numpy.
"""

import argparse
import csv
import os

import numpy as np

from pfann_tpu_torch.data.musicdata import MusicDataset
from pfann_tpu_torch.index.database import MODEL_FILE_NAME
from pfann_tpu_torch.index.embedder import Embedder
from pfann_tpu_torch.utils.config import read_config
from pfann_tpu_torch.utils.device import resolve_device


def best_alignment(emb: np.ndarray, song: np.ndarray, fsm: int):
    """Best (shift, offset) alignment of query rows (at hop/fsm stride)
    against one song's embeddings.  Returns (summed score, offset in
    sub-hop units o*fsm - shift, per-segment details)."""
    slen = song.shape[0]
    best = (-np.inf, 0, None)
    for s in range(fsm):
        sub = emb[s::fsm]
        Ts = sub.shape[0]
        scos = sub @ song.T  # [Ts, slen]
        accum = np.zeros(slen + Ts - 1, dtype=np.float64)
        for k in range(Ts):
            accum[Ts - 1 - k : Ts - 1 - k + slen] += scos[k]
        m = int(np.argmax(accum))
        o = m - (Ts - 1)  # song offset of query row 0
        if accum[m] > best[0]:
            details = []
            for k in range(Ts):
                j = o + k
                if 0 <= j < slen:
                    details.append((float(scos[k, j]), k * fsm + s, j))
            best = (float(accum[m]), o * fsm - s, details)
    return best


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("file_list")
    ap.add_argument("gt")
    ap.add_argument("db")
    ap.add_argument("result")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(None if argv is None else argv[1:])
    device = resolve_device(args.device)

    params = read_config(os.path.join(args.db, "configs.json"))
    d = params["model"]["d"]
    fsm = params["indexer"].get("frame_shift_mul", 1)

    print("loading model...")
    embedder = Embedder(params, os.path.join(args.db, MODEL_FILE_NAME), device)

    print("loading database...")
    with open(os.path.join(args.db, "songList.txt"), encoding="utf8") as fin:
        songList = [line.rstrip("\n") for line in fin]
    counts = np.fromfile(os.path.join(args.db, "landmarkKey"), dtype=np.int32)
    if len(songList) != counts.shape[0]:
        raise ValueError("songList.txt and landmarkKey disagree on the song count")
    song_pos = np.pad(np.cumsum(counts, dtype=np.int64), (1, 0))
    songEmb = np.fromfile(
        os.path.join(args.db, "embeddings"), dtype=np.float32
    ).reshape([-1, d])

    print("loading ground truth...")
    noext = [os.path.splitext(os.path.basename(x))[0] for x in songList]
    gt = {}
    with open(args.gt, encoding="utf8") as fin:
        for line in fin:
            query, ans = line.split("\t")
            gt[query] = noext.index(ans.rstrip())

    dataset = MusicDataset(args.file_list, params)
    with open(args.result, "w", encoding="utf8", newline="\n") as fout:
        writer = csv.writer(fout)
        writer.writerow(["query", "answer", "score", "time", "part_scores"])
        for i, name, wav in dataset:
            query = os.path.splitext(os.path.basename(name))[0]
            if query not in gt:
                print("query %s does not have ground truth" % query)
                continue
            ans_id = gt[query]
            if wav.shape[0] == 0:
                writer.writerow([name, songList[ans_id], -np.inf, 0])
                continue
            emb = embedder.embed(wav)
            song = songEmb[song_pos[ans_id] : song_pos[ans_id + 1]]
            sco, t_subhop, details = best_alignment(emb, song, fsm)
            tim = t_subhop / fsm * params["hop_size"]

            # per-segment rank of the matched DB vector over the whole DB
            upsco = []
            for mysco, tidx, j in details or []:
                scores = emb[tidx] @ songEmb.T
                scores[song_pos[ans_id] + j] = -10
                rank = int((scores >= mysco).sum()) + 1
                upsco += [mysco, tidx, rank]
            writer.writerow([name, songList[ans_id], sco, tim] + upsco)
            fout.flush()


if __name__ == "__main__":
    main()
