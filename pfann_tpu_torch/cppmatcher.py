"""Recognize queries with the standalone native matcher binary, on the port.

    python -m pfann_tpu_torch.cppmatcher <query list> <database dir> \
        <result file> [--device cuda|cpu]

Same argv and TSV as the JAX ``cppmatcher.py``: embeddings are computed
on ``--device`` (default cuda; raises if no card is visible), and each
query's rows are piped to the native matcher (``native/matcher.cpp``,
built with g++ into ``pfann_tpu_torch/_build/``, index/native.py) over
the [u32 len][f32 data] / [i32 best] protocol.
"""

import os
import struct
import subprocess
import sys
import time

import numpy as np

from pfann_tpu_torch.data.musicdata import MusicDataset
from pfann_tpu_torch.index.database import MODEL_FILE_NAME
from pfann_tpu_torch.index.embedder import Embedder
from pfann_tpu_torch.index.native import matcher_binary
from pfann_tpu_torch.utils.config import read_config, read_file_list
from pfann_tpu_torch.utils.device import pop_device_flag, resolve_device
from pfann_tpu_torch.utils.logging import MultiProcessInitLogger, get_logger


def main(argv: list[str] | None = None) -> None:
    MultiProcessInitLogger("cppmatcher")()
    logger = get_logger()
    argv = list(sys.argv if argv is None else argv)
    device = resolve_device(pop_device_flag(argv))
    if len(argv) < 4:
        print("Usage: python -m pfann_tpu_torch.cppmatcher <query list> "
              "<database dir> <result file> [--device cuda|cpu]")
        sys.exit()
    file_list_for_query, dir_for_db, result_file = argv[1:4]
    params = read_config(os.path.join(dir_for_db, "configs.json"))

    print("loading model...")
    embedder = Embedder(params, os.path.join(dir_for_db, MODEL_FILE_NAME), device)
    print("model loaded")
    song_list = read_file_list(os.path.join(dir_for_db, "songList.txt"))

    dataset = MusicDataset(file_list_for_query, params)
    tm_0 = time.time()
    with subprocess.Popen(
        [
            matcher_binary(), dir_for_db,
            str(params["indexer"]["top_k"]),
            str(params["indexer"].get("frame_shift_mul", 1)),
            str(params["indexer"].get("score_alpha", 0)),
        ],
        stdin=subprocess.PIPE,
        stdout=subprocess.PIPE,
    ) as proc, open(result_file, "w", encoding="utf8", newline="\n") as fout:
        for i, name, wav in dataset:
            if wav.shape[0] == 0:
                fout.write("%s\t%s\n" % (name, "error"))
                continue
            emb = embedder.embed(wav).astype(np.float32)
            proc.stdin.write(struct.pack("<I", emb.shape[0]))
            proc.stdin.write(emb.tobytes())
            proc.stdin.flush()
            reply = proc.stdout.read(4)
            if len(reply) != 4:
                raise RuntimeError("native matcher exited (code %s)" % proc.poll())
            (best,) = struct.unpack("<i", reply)
            ans = song_list[best] if best >= 0 else "error"
            fout.write("%s\t%s\n" % (name, ans))
            fout.flush()
        proc.stdin.close()
        if proc.wait() != 0:
            raise RuntimeError("native matcher failed (exit %d)" % proc.returncode)
    logger.info("total query time %.6fs", time.time() - tm_0)


if __name__ == "__main__":
    main()
