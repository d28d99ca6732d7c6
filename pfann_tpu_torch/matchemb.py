"""Match pre-extracted query embeddings against a database, on the port.

    python -m pfann_tpu_torch.matchemb [--batch N] <query embedding dir> \
        <database dir> <result file> [--device cuda|cpu]
    python -m pfann_tpu_torch.matchemb [--batch N] --pairs <database dir> \
        <emb dir 1> <result 1> [<emb dir 2> <result 2> ...]

Same argv and outputs as the JAX ``matchemb.py`` (TSV, _detail.csv,
.bin): ``--batch N`` (default 128) queries go through one
``Database.query_embeddings_batch`` call; ``--pairs`` loads the DB once
for several query sets.  ``--device`` defaults to cuda and raises if no
card is visible.
"""

import csv
import os
import sys
import time

import numpy as np

from pfann_tpu_torch.index.database import Database
from pfann_tpu_torch.utils.config import read_config, read_file_list
from pfann_tpu_torch.utils.device import pop_device_flag, resolve_device
from pfann_tpu_torch.utils.logging import MultiProcessInitLogger, get_logger


def match_set(db: Database, d: int, dir_for_query: str, result_file: str,
              batch: int) -> None:
    """Match one extracted query-embedding dir; writes the TSV +
    _detail.csv + .bin result contract."""
    logger = get_logger()
    result_file2 = os.path.splitext(result_file)[0] + "_detail.csv"
    file_list = read_file_list(os.path.join(dir_for_query, "queryList.txt"))

    print("loading queries")
    query_embeddings = np.fromfile(
        os.path.join(dir_for_query, "query_embeddings"), dtype=np.float32
    ).reshape([-1, d])
    query_index = np.fromfile(
        os.path.join(dir_for_query, "query_index"), dtype=np.int64
    ).reshape([-1, 2])
    print("queries loaded")

    def rows(i):
        return query_embeddings[query_index[i][0] : query_index[i][0] + query_index[i][1]]

    tm_0 = time.time()
    with open(result_file, "w", encoding="utf8", newline="\n") as fout, open(
        result_file2, "w", encoding="utf8", newline="\n"
    ) as fout2, open(result_file + ".bin", "wb") as fout_score:
        detail_writer = csv.writer(fout2)
        detail_writer.writerow(["query", "answer", "score", "time", "part_scores"])
        for at in range(0, len(file_list), batch):
            chunk = list(range(at, min(at + batch, len(file_list))))
            # zero-length (error) extractions answer through query_embeddings,
            # which gives the 'error' line
            full = [i for i in chunk if query_index[i][1] > 0 and db.ntotal > 0]
            answers = {}
            if full:
                answers = dict(zip(full, db.query_embeddings_batch([rows(i) for i in full])))
            for i in chunk:
                if i in answers:
                    sco, (ans_id, tim), song_score = answers[i]
                else:
                    sco, (ans_id, tim), song_score = db.query_embeddings(rows(i))
                name = file_list[i]
                ans = db.songList[ans_id] if ans_id >= 0 else "error"
                fout.write("%s\t%s\n" % (name, ans))
                detail_writer.writerow([name, ans, sco, tim])
                fout_score.write(song_score.tobytes())
            fout.flush()
            fout2.flush()
            logger.info("matchemb batch %d+%d", at, len(chunk))
    logger.info("total query time %.6fs", time.time() - tm_0)


def main(argv: list[str] | None = None) -> None:
    MultiProcessInitLogger("matchemb")()
    logger = get_logger()
    argv = list(sys.argv if argv is None else argv)
    device = resolve_device(pop_device_flag(argv))
    batch = 128
    if "--batch" in argv:
        at = argv.index("--batch")
        batch = int(argv[at + 1])
        del argv[at : at + 2]
    pairs_mode = "--pairs" in argv
    if pairs_mode:
        argv.remove("--pairs")
    usage = ("Usage: python -m pfann_tpu_torch.matchemb [--batch N] <query embedding "
             "dir> <database dir> <result file> [--device cuda|cpu]\n"
             "       python -m pfann_tpu_torch.matchemb [--batch N] --pairs "
             "<database dir> <emb dir> <result> [<emb dir> <result> ...]")
    if pairs_mode:
        if len(argv) < 4 or len(argv) % 2 != 0 or batch < 1:
            print(usage)
            sys.exit()
        dir_for_db = argv[1]
        jobs = list(zip(argv[2::2], argv[3::2]))
    else:
        if len(argv) < 4 or batch < 1:
            print(usage)
            sys.exit()
        dir_for_query, dir_for_db, result_file = argv[1:4]
        jobs = [(dir_for_query, result_file)]
    logger.info("command args: %s", argv)
    params = read_config(os.path.join(dir_for_db, "configs.json"))

    d = params["model"]["d"]
    print("loading database...")
    db = Database(dir_for_db, params["indexer"], params["hop_size"], device)
    print("database loaded")

    for dir_for_query, result_file in jobs:
        logger.info("matchemb sweep: %s -> %s", dir_for_query, result_file)
        match_set(db, d, dir_for_query, result_file, batch)


if __name__ == "__main__":
    main()
