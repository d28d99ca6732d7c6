"""Build a fingerprint database from a music list, on the port.

    python -m pfann_tpu_torch.builder <music list file> <db location> \
        [config or model dir] [--device cuda|cpu]

Same DB directory bytes and layout as the JAX ``builder.py``:
``embeddings``, ``landmarkKey``, ``songList.txt``, ``configs.json``,
``model.msgpack``, ``index_meta.json`` (with ``align_pad`` from
``indexer.max_query_sec``), and a final ``build stats`` JSON line.
``--device`` defaults to cuda and raises if no card is visible.
"""

import json
import os
import shutil
import sys
import time

import numpy as np

from pfann_tpu.data.musicdata import MusicDataset
from pfann_tpu.utils import MultiProcessInitLogger, get_logger, read_config
from pfann_tpu_torch.index.database import MODEL_FILE_NAME, write_index_meta
from pfann_tpu_torch.index.embedder import Embedder
from pfann_tpu_torch.utils.device import pop_device_flag, resolve_device


def build_embeddings(
    embedder, dataset, emb_file, hop_size: float, num_workers: int = 4,
    depth: int = 8,
) -> dict:
    """The build loop: decode stream -> packed embed dispatches -> raw f32
    append, in list order.  Returns {landmark_key, total, stats}.  Uses
    the packed-song path when hop | segment, else host unfold + embed."""
    logger = get_logger()
    landmark_key: list[int] = []
    total = 0
    audio_s = 0.0
    stats = {"decode_s": 0.0, "embed_s": 0.0, "write_s": 0.0}
    hop_samples = dataset.hop_size // dataset.frame_shift_mul
    packed = embedder.can_pack(hop_samples)

    if packed:
        for i, name, z in embedder.embed_stream(
            dataset, hop_samples, num_workers=num_workers, stats=stats,
            depth=depth,
        ):
            if z.shape[0] == 0:
                print("load %s error!" % name)
            landmark_key.append(int(z.shape[0]))
            audio_s += z.shape[0] * hop_size
            tm = time.time()
            emb_file.write(np.ascontiguousarray(z, np.float32).tobytes())
            stats["write_s"] += time.time() - tm
            total += z.shape[0]
    else:
        pending: list[np.ndarray] = []
        pending_rows = 0

        def flush_seg():
            nonlocal pending, pending_rows, total
            if not pending:
                return
            tm = time.time()
            z = embedder.embed(np.concatenate(pending))
            stats["embed_s"] += time.time() - tm
            tm = time.time()
            emb_file.write(z.astype(np.float32).tobytes())
            stats["write_s"] += time.time() - tm
            total += z.shape[0]
            pending = []
            pending_rows = 0

        tm_decode = time.time()
        for i, name, wav in dataset.iterate(num_workers=num_workers):
            stats["decode_s"] += time.time() - tm_decode
            if wav.shape[0] == 0:
                print("load %s error!" % name)
                landmark_key.append(0)
                tm_decode = time.time()
                continue
            landmark_key.append(int(wav.shape[0]))
            audio_s += wav.shape[0] * hop_size
            pending.append(wav)
            pending_rows += wav.shape[0]
            if pending_rows >= max(int(embedder.chunk), 1):
                flush_seg()
            tm_decode = time.time()
        flush_seg()
    stats["audio_s"] = audio_s
    stats["packed"] = packed
    logger.info(
        "build stats decode %.3fs embed %.3fs write %.3fs audio %.1fs",
        stats["decode_s"], stats["embed_s"], stats["write_s"], audio_s,
    )
    return {"landmark_key": landmark_key, "total": total, "stats": stats}


def main(argv: list[str] | None = None) -> None:
    MultiProcessInitLogger("builder")()
    argv = list(sys.argv if argv is None else argv)
    device = resolve_device(pop_device_flag(argv))

    if len(argv) < 3:
        print("Usage: python -m pfann_tpu_torch.builder <music list file> "
              "<db location> [config or model dir] [--device cuda|cpu]")
        sys.exit()
    file_list_for_db = argv[1]
    dir_for_db = argv[2]
    configs = argv[3] if len(argv) >= 4 else "configs/default.json"
    if os.path.isdir(configs):
        configs_path = os.path.join(configs, "configs.json")
        params = read_config(configs_path)
        params["model_dir"] = configs
        configs = configs_path
    else:
        params = read_config(configs)

    print("loading model...")
    model_path = os.path.join(params["model_dir"], MODEL_FILE_NAME)
    embedder = Embedder(params, model_path, device)
    print("model loaded")

    # the DB is always built at the base hop
    params["indexer"]["frame_shift_mul"] = 1
    dataset = MusicDataset(file_list_for_db, params)

    os.makedirs(dir_for_db, exist_ok=True)
    tm_0 = time.time()
    depth = int(os.environ.get("PFANN_BUILD_DEPTH", "8"))
    with open(os.path.join(dir_for_db, "embeddings"), "wb") as emb_file:
        out = build_embeddings(
            embedder, dataset, emb_file, hop_size=params["hop_size"],
            depth=depth,
        )
    landmark_key, total = out["landmark_key"], out["total"]
    wall = time.time() - tm_0
    stats = dict(out["stats"], wall_s=wall, total_embeddings=total,
                 n_songs=len(landmark_key), device=str(device))
    print("total", total, "embeddings")
    print("build stats %s" % json.dumps(stats))
    if total == 0:
        print("The database is empty!")

    np.array(landmark_key, dtype=np.int32).tofile(
        os.path.join(dir_for_db, "landmarkKey")
    )
    shutil.copyfile(file_list_for_db, os.path.join(dir_for_db, "songList.txt"))
    shutil.copyfile(configs, os.path.join(dir_for_db, "configs.json"))
    shutil.copyfile(model_path, os.path.join(dir_for_db, MODEL_FILE_NAME))
    meta = {"ntotal": total}
    max_q = params["indexer"].get("max_query_sec")
    if max_q:
        windows = int(np.ceil(float(max_q) / params["hop_size"]))
        meta["align_pad"] = max(-(-windows // 8) * 8, 32)
        print("align_pad %d (max_query_sec %.1f)"
              % (meta["align_pad"], float(max_q)))
    write_index_meta(dir_for_db, d=embedder.d, meta=meta)


if __name__ == "__main__":
    main()
