"""Noise corpus loading (host) for on-device mixing.

A copy of ``pfann_tpu/data/noise.py``, so that the port imports nothing of the
JAX package.

Parity target: datautil/noise.py:15-60 — read a CSV list, decode each
file, mono mixdown, strip leading/trailing silence (threshold 0), resample
to the model rate, normalize to peak 1, concatenate into one long bank
with a boundary cumsum (kept for name lookups / query generation).  The
mixing itself (noise.py:96-109) runs on device — see ops/augment.py.
"""

from __future__ import annotations

import csv
import os

import numpy as np

from pfann_tpu_torch.audio.io import get_audio
from pfann_tpu_torch.audio.resample import resample


class NoiseData:
    def __init__(self, noise_dir: str, list_csv: str, sample_rate: int,
                 cache_dir: str | None = None):
        print("loading noise dataset")
        with open(list_csv, "r") as fin:
            reader = csv.reader(fin)
            next(reader)
            names = [row[0] for row in reader]

        data = []
        self.names = []
        for name in names:
            smp, smprate = get_audio(os.path.join(noise_dir, name))
            smp = smp.mean(axis=0)
            # strip silence (threshold 0: anything non-zero counts)
            nz = np.flatnonzero(np.abs(smp) > 0)
            if nz.size == 0:
                print("%s too silent" % name)
                continue
            smp = smp[nz[0] : nz[-1] + 1]
            resampled = resample(smp, smprate, sample_rate)
            peak = np.max(np.abs(resampled))
            if peak > 0:
                resampled = resampled / peak
            data.append(resampled.astype(np.float32))
            self.names.append(name)
        self.data = np.concatenate(data) if data else np.zeros(0, np.float32)
        self.boundary = np.cumsum([0] + [x.shape[0] for x in data])
        print(self.data.shape)

    def random_choose(
        self, rng: np.random.Generator, num: int, duration: int,
        out_name: bool = False,
    ):
        """Host-side crops (used by genquery; training crops run on
        device).  Windows may cross file boundaries, as in the reference
        (noise.py:83-93)."""
        starts = rng.integers(0, self.data.shape[0] - duration, num)
        out = np.stack([self.data[s : s + duration] for s in starts])
        if out_name:
            lookup = np.searchsorted(self.boundary, starts, side="right") - 1
            return out, [self.names[i] for i in lookup]
        return out

    def add_noises(
        self, rng: np.random.Generator, x: np.ndarray,
        snr_min: float, snr_max: float, out_name: bool = False,
    ):
        """Host-side SNR mixing (noise.py:96-109), for query generation."""
        eps = 1e-12
        res = self.random_choose(rng, x.shape[0], x.shape[1], out_name=out_name)
        noise, names = res if out_name else (res, None)
        vol_x = np.sqrt(np.clip((x**2).mean(axis=1), eps, None))
        vol_n = np.sqrt(np.clip((noise**2).mean(axis=1), eps, None))
        snr = rng.uniform(snr_min, snr_max, x.shape[0])
        ratio = vol_x / vol_n * 10 ** (-snr / 20)
        x_aug = x + ratio[:, None] * noise
        if out_name:
            return x_aug, names, snr
        return x_aug
