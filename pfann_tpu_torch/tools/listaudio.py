"""Recursively list audio files with durations into a CSV.

Parity: reference tools/listaudio.py — scans a folder for known audio
extensions, probes duration/sample-rate/channels, writes
[file, duration, sample_rate, channels] CSV (or a plain txt list),
optional random sampling.  WAV files are probed with the stdlib reader;
other formats need ffprobe.

    python -m pfann_tpu_torch.tools.listaudio --folder <dir> [--sample N] [--out out.csv]

A copy of the JAX ``tools/listaudio.py`` over the port's ``audio/io.py``.
"""

import argparse
import csv
import concurrent.futures
import os
import random
import wave

from pfann_tpu_torch.audio.io import _PatchedFormatWave, ffprobe_info, have_ffmpeg

FORMATS = {".wav", ".mp3", ".m4a", ".aac", ".ogg", ".flac", ".webm"}


def probe(path):
    try:
        if path.endswith(".wav"):
            with open(path, "rb") as fin:
                w = wave.open(_PatchedFormatWave(fin))
                return (
                    w.getnframes() / w.getframerate(),
                    w.getframerate(),
                    w.getnchannels(),
                )
        if have_ffmpeg():
            info = ffprobe_info(path)
            return (
                float(info.get("duration", 0)),
                int(info["sample_rate"]),
                int(info["channels"]),
            )
        print("cannot probe %s (no ffprobe)" % path)
    except Exception:
        print("failed to decode %s. maybe the file is broken!" % path)
    return None


def find_all_audio(folder):
    found = []
    for dirpath, _, names in os.walk(folder):
        rel = os.path.relpath(dirpath, folder)
        for name in sorted(names):
            if os.path.splitext(name)[1] in FORMATS:
                found.append(os.path.normpath(os.path.join(rel, name)))
    return found


def main(argv: list[str] | None = None) -> None:
    argp = argparse.ArgumentParser()
    argp.add_argument("--folder", required=True)
    argp.add_argument("--sample", type=int)
    argp.add_argument("--threads", type=int, default=4)
    argp.add_argument("--out", default="out.csv")
    args = argp.parse_args(None if argv is None else argv[1:])

    print("searching audio files...")
    rels = find_all_audio(args.folder)
    rows = []
    with concurrent.futures.ThreadPoolExecutor(max_workers=args.threads) as ex:
        for rel, du in zip(rels, ex.map(lambda r: probe(os.path.join(args.folder, r)), rels)):
            if du is not None:
                rows.append([rel, *du])
    rows.sort()
    if args.sample:
        rows = random.sample(rows, args.sample)
    with open(args.out, "w", encoding="utf8", newline="\n") as fout:
        if args.out.endswith(".csv"):
            writer = csv.writer(fout, lineterminator="\r\n")
            writer.writerow(["file", "duration", "sample_rate", "channels"])
            writer.writerows(rows)
        else:
            for row in rows:
                fout.write(row[0] + "\n")


if __name__ == "__main__":
    main()
