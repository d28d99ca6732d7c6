"""Re-index an existing database with different search settings, without
re-computing embeddings, on the port.

    python -m pfann_tpu_torch.rebuild <db location>

Same argv and effect as the JAX ``rebuild.py``: the engines search the
embeddings directly, so rebuilding rewrites ``index_meta.json`` from the
(possibly edited) configs.json indexer section after checking the
embedding file's shape against landmarkKey.  It touches no device.
"""

import os
import sys

import numpy as np

from pfann_tpu_torch.index.database import INDEX_META_NAME, write_index_meta
from pfann_tpu_torch.utils.config import read_config


def main(argv: list[str] | None = None) -> None:
    argv = list(sys.argv if argv is None else argv)
    if len(argv) < 2:
        print("Usage: python -m pfann_tpu_torch.rebuild <db location>")
        sys.exit()
    dir_for_db = argv[1]
    params = read_config(os.path.join(dir_for_db, "configs.json"))
    d = params["model"]["d"]

    print("loading embeddings")
    embeddings = np.fromfile(
        os.path.join(dir_for_db, "embeddings"), dtype=np.float32
    ).reshape([-1, d])
    counts = np.fromfile(os.path.join(dir_for_db, "landmarkKey"), dtype=np.int32)
    if embeddings.shape[0] != counts.sum():
        raise ValueError("embeddings (%d) inconsistent with landmarkKey (%d)"
                         % (embeddings.shape[0], counts.sum()))

    print("writing index metadata")
    indexer = dict(params.get("indexer", {}))
    indexer.pop("index_factory", None)  # faiss-only concept
    write_index_meta(dir_for_db, d=d, meta={"ntotal": int(embeddings.shape[0]), **indexer})
    print("index metadata written to", os.path.join(dir_for_db, INDEX_META_NAME))


if __name__ == "__main__":
    main()
