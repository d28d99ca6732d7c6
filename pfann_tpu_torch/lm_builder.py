"""Build a landmark-system database (the ``lm*`` models of testall.sh), on
the port.

    python -m pfann_tpu_torch.lm_builder <music list> <db dir> [sample_rate] \
        [--device cuda|cpu]

Same files as the JAX ``lm_builder.py``: ``landmarks.npz``,
``songList.txt`` and ``lm_meta.json``.  The spectrogram and peak stage
runs batched on ``--device`` (default cuda, which raises where no card is
visible) through ``landmark.device.DevicePeakExtractor``; pairing and
the index stay on the host.  ``PFANN_LM_DEVICE=0`` asks for the numpy
host path instead.
"""

import os
import sys
import time

import numpy as np

from pfann_tpu_torch.audio.io import get_audio
from pfann_tpu_torch.audio.resample import resample
from pfann_tpu_torch.landmark import LandmarkIndex
from pfann_tpu_torch.landmark.device import DevicePeakExtractor, as_device_input
from pfann_tpu_torch.utils.config import read_file_list
from pfann_tpu_torch.utils.device import pop_device_flag, resolve_device
from pfann_tpu_torch.utils.logging import MultiProcessInitLogger, get_logger


def load_mono(path: str, sr: int):
    wav, rate = get_audio(path)
    wav = wav.mean(axis=0)
    if rate != sr:
        wav = resample(wav, rate, sr)
    return wav


def make_extractor(device, logger=None):
    """The batched peak extractor on ``device``, or None for the numpy
    host path when PFANN_LM_DEVICE=0 asks for it."""
    if os.environ.get("PFANN_LM_DEVICE") == "0":
        return None
    if logger is not None:
        logger.info("landmark device extraction on %s", device)
    return DevicePeakExtractor(device=device)


def main(argv: list[str] | None = None) -> None:
    MultiProcessInitLogger("lmbuilder")()
    logger = get_logger()
    argv = list(sys.argv if argv is None else argv)
    device = resolve_device(pop_device_flag(argv))
    if len(argv) < 3:
        print("Usage: python -m pfann_tpu_torch.lm_builder <music list> <db dir> "
              "[sample_rate] [--device cuda|cpu]")
        sys.exit()
    music_list, db_dir = argv[1:3]
    sr = int(argv[3]) if len(argv) > 3 else 8000

    files = read_file_list(music_list)
    extractor = make_extractor(device, logger)

    def signals():
        for path in files:
            tm = time.time()
            try:
                wav = load_mono(path, sr)
            except Exception as e:
                logger.error("load %s error: %r", path, e)
                wav = np.zeros(0, dtype=np.float32)
            if extractor is not None:
                wav = as_device_input(wav)
            logger.info("load %s %.6fs", path, time.time() - tm)
            yield wav

    idx = LandmarkIndex.build(signals(), song_list=files, extractor=extractor)
    idx.save(db_dir)
    print("landmark db: %d songs, %d hashes" % (idx.n_songs, idx.hashes.shape[0]))


if __name__ == "__main__":
    main()
