"""Match queries against a landmark database (the ``lm*`` models of
testall.sh), on the port.

    python -m pfann_tpu_torch.lm_matcher <query list> <db dir> <result file> \
        [sample_rate] [--device cuda|cpu]

Outputs, byte for byte those of the JAX ``lm_matcher.py`` (the contract
ensemble/lmscore.py and tools/accuracy.py read):
  <result>        TSV  query \\t answer
  <result>.csv    query, answer, time   (CSV with header)
  <result>.bin    int32 [n_query, n_songs, 2]: col 0 = best offset
                  (frames), col 1 = vote score
The peak stage runs batched on ``--device`` (default cuda, which raises
where no card is visible); ``PFANN_LM_DEVICE=0`` asks for the numpy host
path.
"""

import csv
import sys
import time

import numpy as np

from pfann_tpu_torch.landmark import LandmarkIndex
from pfann_tpu_torch.landmark.core import HOP, extract_hashes, pair_peaks
from pfann_tpu_torch.landmark.device import as_device_input
from pfann_tpu_torch.lm_builder import load_mono, make_extractor
from pfann_tpu_torch.utils.config import read_file_list
from pfann_tpu_torch.utils.device import pop_device_flag, resolve_device
from pfann_tpu_torch.utils.logging import MultiProcessInitLogger, get_logger


def main(argv: list[str] | None = None) -> None:
    MultiProcessInitLogger("lmmatcher")()
    logger = get_logger()
    argv = list(sys.argv if argv is None else argv)
    device = resolve_device(pop_device_flag(argv))
    if len(argv) < 4:
        print("Usage: python -m pfann_tpu_torch.lm_matcher <query list> <db dir> "
              "<result file> [sample_rate] [--device cuda|cpu]")
        sys.exit()
    query_list, db_dir, result_file = argv[1:4]
    sr = int(argv[4]) if len(argv) > 4 else 8000

    idx = LandmarkIndex.load(db_dir)
    queries = read_file_list(query_list)
    extractor = make_extractor(device, logger)
    batch = extractor.batch if extractor is not None else 1

    def hash_batch(paths):
        """[(hashes, t_anchor)] per query: peaks batched on the device, or
        the numpy path under PFANN_LM_DEVICE=0."""
        wavs = []
        for path in paths:
            try:
                wavs.append(load_mono(path, sr))
            except Exception as e:
                logger.error("load %s error: %r", path, e)
                wavs.append(np.zeros(0, dtype=np.float32))
        if extractor is None:
            return [extract_hashes(w) for w in wavs]
        peaks = extractor.extract([as_device_input(w) for w in wavs])
        return [pair_peaks(p) for p in peaks]

    with open(result_file, "w", encoding="utf8", newline="\n") as fout, open(
        result_file + ".csv", "w", encoding="utf8", newline=""
    ) as fcsv, open(result_file + ".bin", "wb") as fbin:
        writer = csv.writer(fcsv)
        writer.writerow(["query", "answer", "time"])
        for at in range(0, len(queries), batch):
            chunk = queries[at : at + batch]
            tm = time.time()
            hashed = hash_batch(chunk)
            for path, (h, tq) in zip(chunk, hashed):
                best, table = idx.query_hashes(h, tq)
                ans = idx.song_list[best] if best >= 0 else "error"
                t = table[best, 0] * HOP / sr if best >= 0 else 0.0
                fout.write("%s\t%s\n" % (path, ans))
                writer.writerow([path, ans, t])
                fbin.write(table.astype(np.int32).tobytes())
            logger.info("query batch %d+%d %.6fs", at, len(chunk), time.time() - tm)
    logger.info("done: %d queries", len(queries))


if __name__ == "__main__":
    main()
