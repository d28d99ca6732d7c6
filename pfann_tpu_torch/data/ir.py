"""Impulse-response corpora (host loading -> frequency-domain banks).

A copy of ``pfann_tpu/data/ir.py``, so that the port imports nothing of the
JAX package.

Parity targets:
  * datautil/ir.py:16-48 — Aachen Impulse Response .mat files (scipy.io,
    key ``h_air``, sample rate from ``air_info.fs``, room name recorded),
    resampled, truncated to ``length`` seconds, pre-FFT'd at fftconv_n.
  * datautil/ir.py:50-72 — microphone IRs from audio files, same
    treatment.

The per-batch random choice and the spectral multiply run on device
(ops/augment.py: ir_convolve); these classes only produce the complex
spectra banks [n, fftconv_n//2 + 1].
"""

from __future__ import annotations

import csv
import os

import numpy as np

from pfann_tpu_torch.audio.io import get_audio
from pfann_tpu_torch.audio.resample import resample


def _read_list(list_csv: str) -> list[str]:
    with open(list_csv, "r") as fin:
        reader = csv.reader(fin)
        next(reader)
        return [row[0] for row in reader]


class AIR:
    def __init__(self, air_dir: str, list_csv: str, length: float,
                 fftconv_n: int, sample_rate: int = 8000):
        import scipy.io

        print("loading Aachen IR dataset")
        to_len = int(length * sample_rate)
        data, self.names = [], []
        for name in _read_list(list_csv):
            mat = scipy.io.loadmat(os.path.join(air_dir, name))
            h_air = np.asarray(mat["h_air"], dtype=np.float32)
            assert h_air.shape[0] == 1
            h_air = h_air[0]
            air_info = mat["air_info"]
            fs = int(air_info["fs"][0][0][0][0])
            self.names.append(str(air_info["room"][0][0][0]))
            resampled = resample(h_air, fs, sample_rate)[:to_len]
            data.append(np.fft.rfft(resampled, fftconv_n))
        self.data = np.stack(data).astype(np.complex64)

    def random_choose_name(self, rng: np.random.Generator):
        i = int(rng.integers(0, self.data.shape[0]))
        return self.data[i], self.names[i]


class MicIRP:
    def __init__(self, mic_dir: str, list_csv: str, length: float,
                 fftconv_n: int, sample_rate: int = 8000):
        print("loading microphone IR dataset")
        to_len = int(length * sample_rate)
        data = []
        for name in _read_list(list_csv):
            smp, smprate = get_audio(os.path.join(mic_dir, name))
            smp = smp.mean(axis=0)
            resampled = resample(smp, smprate, sample_rate)[:to_len]
            data.append(np.fft.rfft(resampled, fftconv_n))
        self.data = np.stack(data).astype(np.complex64)

    def random_choose(self, rng: np.random.Generator, num: int) -> np.ndarray:
        return self.data[rng.integers(0, self.data.shape[0], num)]


def _main():
    """List .mat IR files in a directory to CSV (reference ir.py:74-89:
    ``python -m pfann_tpu_torch.data.ir <air dir> <out csv>``)."""
    import argparse

    args = argparse.ArgumentParser()
    args.add_argument("air")
    args.add_argument("out")
    args = args.parse_args()
    with open(args.out, "w", encoding="utf8", newline="\n") as fout:
        writer = csv.writer(fout)
        writer.writerow(["file"])
        for name in sorted(os.listdir(args.air)):
            if name.endswith(".mat"):
                writer.writerow([name])


if __name__ == "__main__":
    _main()
