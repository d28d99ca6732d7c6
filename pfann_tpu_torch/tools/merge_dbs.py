"""Merge built DB directories into one (sharded-build concatenation), on
the port.

    python -m pfann_tpu_torch.tools.merge_dbs <out_db> <src_db1> <src_db2> [...]

Same bytes as the JAX ``tools/merge_dbs.py``.  The DB-dir contract
(embeddings f32 [N, d] raw / landmarkKey int32 per-song counts /
songList.txt / index_meta.json / configs.json) is order-concatenable:
song i of shard k keeps its embedding rows contiguous, so merging is a
byte-level concat of the three per-song files plus an ntotal rewrite.
configs.json and model.msgpack come from the FIRST source (the merge
refuses mismatched embedding dims; every shard must have been embedded
by the same model).
"""

import json
import os
import shutil
import sys

import numpy as np

from pfann_tpu_torch.index.database import INDEX_META_NAME, write_index_meta


def merge_dbs(out_dir: str, src_dirs: list) -> dict:
    if not src_dirs:
        raise ValueError("need at least one source DB")
    metas = []
    for s in src_dirs:
        with open(os.path.join(s, INDEX_META_NAME)) as f:
            metas.append(json.load(f))
    d = int(metas[0]["d"])
    for s, m in zip(src_dirs, metas):
        if int(m["d"]) != d:
            raise ValueError("embedding dim mismatch: %s has d=%s, %s has d=%d"
                             % (s, m["d"], src_dirs[0], d))
    os.makedirs(out_dir, exist_ok=True)

    ntotal = 0
    n_songs = 0
    with open(os.path.join(out_dir, "embeddings"), "wb") as emb_out, \
         open(os.path.join(out_dir, "landmarkKey"), "wb") as key_out, \
         open(os.path.join(out_dir, "songList.txt"), "w") as list_out:
        for s in src_dirs:
            counts = np.fromfile(os.path.join(s, "landmarkKey"), dtype=np.int32)
            with open(os.path.join(s, "songList.txt")) as f:
                names = f.read().splitlines()
            if len(names) != counts.shape[0]:
                raise ValueError("%s: %d songs listed, %d counts"
                                 % (s, len(names), counts.shape[0]))
            rows = int(counts.sum())
            emb_path = os.path.join(s, "embeddings")
            if os.path.getsize(emb_path) != rows * d * 4:
                raise ValueError("embeddings/landmarkKey inconsistent in %s" % s)
            with open(emb_path, "rb") as f:
                shutil.copyfileobj(f, emb_out, length=1 << 24)
            counts.tofile(key_out)
            list_out.write("".join(n + "\n" for n in names))
            ntotal += rows
            n_songs += len(names)

    merged_meta = {"ntotal": ntotal}
    # align_pad sizes the layout for the longest query the DB was built to
    # serve; the MAX across shards keeps every shard's contract
    pads = [int(m["align_pad"]) for m in metas if m.get("align_pad")]
    if pads:
        merged_meta["align_pad"] = max(pads)
    write_index_meta(out_dir, d=d, meta=merged_meta)
    for name in ("configs.json", "model.msgpack"):
        src = os.path.join(src_dirs[0], name)
        if os.path.exists(src):
            shutil.copyfile(src, os.path.join(out_dir, name))
    return {"n_songs": n_songs, "ntotal": ntotal, "d": d}


def main(argv: list[str] | None = None) -> None:
    argv = list(sys.argv if argv is None else argv)
    if len(argv) < 3:
        sys.exit(__doc__)
    out_dir, srcs = argv[1], argv[2:]
    info = merge_dbs(out_dir, srcs)
    print("%s: %d songs, %d embeddings (d=%d) from %d shards"
          % (out_dir, info["n_songs"], info["ntotal"], info["d"], len(srcs)))


if __name__ == "__main__":
    main()
