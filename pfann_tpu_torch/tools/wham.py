"""Convert WHAM! noise recordings into an audioset-format noise corpus.

Parity: reference tools/wham.py — copy clips from wham tr/cv splits until
a 2.3 h total budget (80/20 split), writing per-split list.csv with
durations.  Durations come from the WAV header (no miniaudio needed).

    python -m pfann_tpu_torch.tools.wham --wham <wham dir> --audioset <out dir>

A copy of the JAX ``tools/wham.py`` over the port's ``audio/io.py``.
"""

import argparse
import csv
import os
import random
import shutil
import wave

from pfann_tpu_torch.audio.io import _PatchedFormatWave

TOTAL_HOURS = 2.3
TOTAL_SECS = TOTAL_HOURS * 3600


def wav_duration(path: str) -> float:
    with open(path, "rb") as fin:
        w = wave.open(_PatchedFormatWave(fin))
        return w.getnframes() / w.getframerate()


def gen_clips(noise_dir, noises, out_dir, out_type, total_secs):
    acc = 0.0
    rows = []
    out_dir = os.path.join(out_dir, out_type)
    os.makedirs(out_dir, exist_ok=True)
    for name in noises:
        src = os.path.join(noise_dir, name)
        du = wav_duration(src)
        rows.append([os.path.join(out_type, name), du])
        acc += du
        shutil.copyfile(src, os.path.join(out_dir, name))
        if acc >= total_secs:
            break
    with open(os.path.join(out_dir, "list.csv"), "w", encoding="utf8",
              newline="\n") as fout:
        csv.writer(fout).writerows(rows)
    return rows


def main(argv: list[str] | None = None) -> None:
    args = argparse.ArgumentParser()
    args.add_argument("--wham", required=True)
    args.add_argument("--audioset", required=True)
    args = args.parse_args(None if argv is None else argv[1:])

    for split, budget in (("tr", TOTAL_SECS * 0.8), ("cv", TOTAL_SECS * 0.2)):
        wham_dir = os.path.join(args.wham, split)
        noises = os.listdir(wham_dir)
        random.shuffle(noises)
        gen_clips(wham_dir, noises, args.audioset, split, budget)


if __name__ == "__main__":
    main()
