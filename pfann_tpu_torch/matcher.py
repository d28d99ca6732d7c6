"""Recognize queries against a fingerprint database, on the port.

    python -m pfann_tpu_torch.matcher <query list> <database dir> <result file> \
        [batch] [--top1] [--batch N] [--device cuda|cpu]
    python -m pfann_tpu_torch.matcher --pairs [--batch N] <database dir> \
        <list1> <result1> [<list2> <result2> ...]

Same argv contract and outputs as the JAX ``matcher.py``:
  <result>              TSV: query path \\t answer path
  <result stem>_detail.csv: query, answer, score, time
  <result>.bin          per-query [n_songs, 2] float32 (score, time) blocks
                        (not written with --top1, which serves answers only)
``--visualize`` (gradient saliency) is not ported and raises.
``--device`` defaults to cuda and raises if no card is visible.
"""

import contextlib
import csv
import os
import sys
import time

import numpy as np
import torch

from pfann_tpu_torch.data.musicdata import MusicDataset
from pfann_tpu_torch.index.database import MODEL_FILE_NAME, Database
from pfann_tpu_torch.index.embedder import Embedder
from pfann_tpu_torch.utils.config import read_config
from pfann_tpu_torch.utils.device import pop_device_flag, resolve_device
from pfann_tpu_torch.utils.logging import MultiProcessInitLogger, get_logger

_VISUALIZE = ("--visualize (gradient saliency) is not ported "
              "(ROADMAP: saliency / --visualize)")


def match_list(
    embedder, db, params, file_list_for_query, result_file,
    batch=32, top1=False,
) -> None:
    """Match every query in one list file against a loaded DB.  ``top1``
    serves answers through Database.query_top1_batch and writes no .bin
    tables; its TSV and _detail.csv answers equal the default mode's."""
    logger = get_logger()
    os.makedirs(os.path.dirname(os.path.abspath(result_file)), exist_ok=True)
    result_file2 = os.path.splitext(result_file)[0] + "_detail.csv"
    result_file_score = result_file + ".bin"
    dataset = MusicDataset(file_list_for_query, params)

    tm_0 = time.time()
    with contextlib.ExitStack() as stack:
        fout = stack.enter_context(
            open(result_file, "w", encoding="utf8", newline="\n"))
        fout2 = stack.enter_context(
            open(result_file2, "w", encoding="utf8", newline="\n"))
        fout_score = None if top1 else stack.enter_context(
            open(result_file_score, "wb"))
        detail_writer = csv.writer(fout2)
        detail_writer.writerow(["query", "answer", "score", "time", "part_scores"])

        # (name, ("wav", segments) | ("raw", (signal, n_seg))); queries are
        # packed into shared embed calls at flush time
        hop = dataset.hop_size // dataset.frame_shift_mul
        packed_mode = embedder.can_pack(hop)
        pending: list = []

        def flush():
            nonlocal pending
            if not pending:
                return
            embs: list = [None] * len(pending)
            raw_idx = [i for i, (_, (kind, _)) in enumerate(pending) if kind == "raw"]
            wav_idx = [i for i, (_, (kind, _)) in enumerate(pending) if kind == "wav"]
            if raw_idx:
                tm = time.time()
                zs = embedder.embed_songs(
                    [pending[i][1][1][0] for i in raw_idx],
                    [pending[i][1][1][1] for i in raw_idx], hop,
                )
                for i, z in zip(raw_idx, zs):
                    embs[i] = z
                logger.info("compute embedding %.6fs", time.time() - tm)
            if wav_idx:
                tm = time.time()
                packed = embedder.embed(
                    np.concatenate([pending[i][1][1] for i in wav_idx])
                )
                lens = np.cumsum([pending[i][1][1].shape[0] for i in wav_idx])
                for i, part in zip(wav_idx, np.split(packed, lens[:-1])):
                    embs[i] = part
                logger.info("compute embedding %.6fs", time.time() - tm)
            tm = time.time()
            if top1:
                for (name, _), (sco, (ans_id, tim)) in zip(
                    pending, db.query_top1_batch(embs)
                ):
                    ans = db.songList[ans_id] if ans_id >= 0 else "error"
                    fout.write("%s\t%s\n" % (name, ans))
                    detail_writer.writerow([name, ans, sco, tim])
            else:
                for (name, _), (sco, (ans_id, tim), song_score) in zip(
                    pending, db.query_embeddings_batch(embs)
                ):
                    ans = db.songList[ans_id] if ans_id >= 0 else "error"
                    fout.write("%s\t%s\n" % (name, ans))
                    detail_writer.writerow([name, ans, sco, tim])
                    fout_score.write(song_score.tobytes())
            logger.info("search %.6fs", time.time() - tm)
            fout.flush()
            fout2.flush()
            pending = []

        def rows():
            if packed_mode:
                for i, name, sig, n_seg in dataset.iterate_raw(num_workers=4):
                    yield name, ("raw", (sig, n_seg)) if n_seg > 0 else None
            else:
                for i, name, wav in dataset.iterate(num_workers=4):
                    yield name, ("wav", wav) if wav.shape[0] > 0 else None

        for name, item in rows():
            logger.info("get query %s", name)
            if item is None:
                flush()  # keep output order
                logger.error("load %s error!", name)
                fout.write("%s\t%s\n" % (name, "error"))
                fout.flush()
                detail_writer.writerow([name, "error", -float("inf"), 0])
                fout2.flush()
                if fout_score is not None:
                    fout_score.write(
                        np.zeros([len(db.songList), 2], dtype=np.float32).tobytes()
                    )
                continue
            pending.append((name, item))
            if len(pending) >= batch:
                flush()
        flush()
    logger.info("total query time %.6fs", time.time() - tm_0)


def load_model_and_db(dir_for_db, device: torch.device):
    params = read_config(os.path.join(dir_for_db, "configs.json"))
    print("loading model...")
    # bigger embed chunks on the card: fewer, larger calls
    chunk = 2048 if device.type == "cuda" else 512
    embedder = Embedder(
        params, os.path.join(dir_for_db, MODEL_FILE_NAME), device, chunk=chunk
    )
    print("model loaded")
    print("loading database...")
    db = Database(dir_for_db, params["indexer"], params["hop_size"], device)
    print("database loaded")
    return embedder, db, params


def main(argv: list[str] | None = None) -> None:
    MultiProcessInitLogger("nnmatcher")()
    argv = list(sys.argv if argv is None else argv)
    device = resolve_device(pop_device_flag(argv))
    if "--visualize" in argv:
        raise NotImplementedError(_VISUALIZE)
    pairs_mode = "--pairs" in argv
    if pairs_mode:
        argv.remove("--pairs")
    top1_flag = "--top1" in argv
    if top1_flag:
        argv.remove("--top1")
    batch = 32
    if "--batch" in argv:
        at = argv.index("--batch")
        batch = int(argv[at + 1])
        del argv[at : at + 2]

    if pairs_mode:
        if len(argv) < 4 or (len(argv) - 2) % 2 != 0:
            print("Usage: python -m pfann_tpu_torch.matcher --pairs [--batch N] "
                  "<database dir> <list1> <result1> [<list2> <result2> ...]")
            sys.exit()
        dir_for_db = argv[1]
        pairs = list(zip(argv[2::2], argv[3::2]))
    else:
        if len(argv) < 4:
            print("Usage: python -m pfann_tpu_torch.matcher <query list> "
                  "<database dir> <result file> [batch] [--top1] [--device cuda|cpu]")
            sys.exit()
        dir_for_db = argv[2]
        pairs = [(argv[1], argv[3])]
        batch = int(argv[4]) if len(argv) > 4 else batch

    embedder, db, params = load_model_and_db(dir_for_db, device)
    if params["indexer"].get("visualize", False):
        raise NotImplementedError(_VISUALIZE)
    for file_list_for_query, result_file in pairs:
        match_list(
            embedder, db, params, file_list_for_query, result_file,
            batch=batch, top1=top1_flag,
        )


if __name__ == "__main__":
    main()
