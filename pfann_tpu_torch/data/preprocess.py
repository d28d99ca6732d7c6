"""Music corpus preprocessing cache (a copy of
``pfann_tpu/data/preprocess.py`` over the port's ``audio/``).

Parity target: reference datautil/preprocess.py:13-56 — decode + resample
the whole corpus once into ``<cache>/1<listname>.bin`` (concatenated int16
mono at the target rate) and ``<cache>/1<listname>.npy`` (int64 per-song
sample counts).  The cache format is byte-identical to the reference's so
caches interoperate.
"""

from __future__ import annotations

import concurrent.futures
import csv
import os

import numpy as np

from pfann_tpu_torch.audio.io import get_audio
from pfann_tpu_torch.audio.resample import resample


def _load_one(args) -> np.ndarray:
    path, sample_rate = args
    wav, smprate = get_audio(path)
    wav = wav.mean(axis=0)  # mono
    wav = resample(wav, smprate, sample_rate)
    return np.clip(wav * 32768, -32768, 32767).astype(np.int16)


def preprocess_music(
    music_dir: str,
    music_csv: str,
    sample_rate: int,
    preprocess_out: str,
    num_workers: int = 4,
) -> None:
    """Decode/resample every file in the csv into the bin+npy cache
    (preprocess.py:38-56)."""
    print("converting music to wav")
    with open(music_csv) as fin:
        reader = csv.reader(fin)
        next(reader)
        files = [os.path.join(music_dir, row[0]) for row in reader]

    song_lens = []
    with open(preprocess_out + ".bin", "wb") as out_file:
        with concurrent.futures.ThreadPoolExecutor(max_workers=max(num_workers, 1)) as ex:
            for wav in ex.map(_load_one, ((f, sample_rate) for f in files)):
                out_file.write(wav.tobytes())
                song_lens.append(wav.shape[0])
    np.save(preprocess_out, np.array(song_lens, dtype=np.int64))


def cache_path(cache_dir: str, list_csv: str) -> str:
    """'1' + basename-sans-ext, under cache_dir (dataset_v2.py:74-75)."""
    file_name = os.path.splitext(os.path.split(list_csv)[1])[0]
    return os.path.join(cache_dir, "1" + file_name)


def ensure_music_cache(params: dict, train_val: str, num_workers: int = 4) -> str:
    """Build the cache if missing; returns the path prefix
    (dataset_v2.py:74-80).

    The cache name is keyed by the csv BASENAME only (reference byte
    contract), so two corpora whose lists share a basename would collide
    silently; guard by comparing the cached song count against the csv
    row count and rebuilding on mismatch (the reference has the same
    footgun with no guard)."""
    cache_dir = params["cache_dir"]
    os.makedirs(cache_dir, exist_ok=True)
    list_csv = params[train_val + "_csv"]
    prefix = cache_path(cache_dir, list_csv)
    if os.path.exists(prefix + ".npy"):
        with open(list_csv) as fin:
            n_rows = sum(1 for _ in csv.reader(fin)) - 1
        if np.load(prefix + ".npy").shape[0] != n_rows:
            print(
                "cached %s.bin holds a different corpus (%s basename "
                "collision) - rebuilding" % (prefix, list_csv)
            )
            preprocess_music(
                params["music_dir"], list_csv, params["sample_rate"],
                prefix, num_workers=num_workers,
            )
            return prefix
        print("load cached music from %s.bin" % prefix)
    else:
        preprocess_music(
            params["music_dir"],
            params[train_val + "_csv"],
            params["sample_rate"],
            prefix,
            num_workers=num_workers,
        )
    return prefix
