"""Extract query embeddings once, to be matched against many index
configurations, on the port.

    python -m pfann_tpu_torch.extractemb <query list> <database dir> \
        <output embedding dir> [--device cuda|cpu]

Same argv and output directory as the JAX ``extractemb.py``:
query_embeddings (raw f32), query_index (int64 [start, len] pairs; errors
recorded as len 0), queryList.txt, configs.json.  ``--device`` defaults
to cuda and raises if no card is visible.
"""

import os
import shutil
import sys
import time

import numpy as np

from pfann_tpu_torch.data.musicdata import MusicDataset
from pfann_tpu_torch.index.database import MODEL_FILE_NAME
from pfann_tpu_torch.index.embedder import Embedder
from pfann_tpu_torch.utils.config import read_config
from pfann_tpu_torch.utils.device import pop_device_flag, resolve_device
from pfann_tpu_torch.utils.logging import MultiProcessInitLogger, get_logger


def main(argv: list[str] | None = None) -> None:
    MultiProcessInitLogger("nnextract")()
    logger = get_logger()
    argv = list(sys.argv if argv is None else argv)
    device = resolve_device(pop_device_flag(argv))
    if len(argv) < 4:
        print("Usage: python -m pfann_tpu_torch.extractemb <query list> "
              "<database dir> <output embedding dir> [--device cuda|cpu]")
        sys.exit()
    file_list_for_query, dir_for_db, out_embed_dir = argv[1:4]
    configs = os.path.join(dir_for_db, "configs.json")
    params = read_config(configs)

    print("loading model...")
    embedder = Embedder(params, os.path.join(dir_for_db, MODEL_FILE_NAME), device)
    print("model loaded")

    dataset = MusicDataset(file_list_for_query, params)
    os.makedirs(out_embed_dir, exist_ok=True)
    tm_0 = time.time()
    idx_pos = 0
    hop = dataset.hop_size // dataset.frame_shift_mul
    with open(os.path.join(out_embed_dir, "query_embeddings"), "wb") as emb_file, \
         open(os.path.join(out_embed_dir, "query_index"), "wb") as idx_file:
        if embedder.can_pack(hop):
            stream = embedder.embed_stream(dataset, hop, num_workers=4)
        else:
            stream = (
                (i, name, embedder.embed(wav) if wav.shape[0]
                 else np.zeros((0, embedder.d), np.float32))
                for i, name, wav in dataset.iterate(num_workers=4)
            )
        for i, name, z in stream:
            if z.shape[0] == 0:
                logger.error("load %s error!", name)
            emb_file.write(np.ascontiguousarray(z, np.float32).tobytes())
            idx_file.write(np.array([idx_pos, z.shape[0]], dtype=np.int64).tobytes())
            idx_pos += z.shape[0]
    print("total", idx_pos, "embeddings")
    shutil.copyfile(file_list_for_query, os.path.join(out_embed_dir, "queryList.txt"))
    shutil.copyfile(configs, os.path.join(out_embed_dir, "configs.json"))
    logger.info("total extract time %.6fs", time.time() - tm_0)


if __name__ == "__main__":
    main()
