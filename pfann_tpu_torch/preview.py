"""Dump a few augmented training batches as listenable WAV files, on the
port (``preview.py``'s counterpart).

    python -m pfann_tpu_torch.preview -p configs/default.json -o preview_out \
        [-n 3] [--device cuda|cpu]

Takes the validation loader's org and augmented waveforms before the mel
front end (noise, then the room and mic impulse responses, applied on the
device with draws from a seeded generator), interleaves each pair and
writes 30 s per batch, each segment peak-normalised.
"""

import argparse
import os
import sys

import numpy as np
import torch

from pfann_tpu_torch.audio.io import write_wav
from pfann_tpu_torch.data.segments import SegmentedDataLoader
from pfann_tpu_torch.data.shuffler import batched
from pfann_tpu_torch.utils.config import read_config
from pfann_tpu_torch.utils.device import resolve_device
from pfann_tpu_torch.utils.rng import seeded_generator


def main(argv: list[str] | None = None) -> None:
    argv = list(sys.argv if argv is None else argv)
    ap = argparse.ArgumentParser(prog="python -m pfann_tpu_torch.preview")
    ap.add_argument("-p", "--params", default="configs/default.json")
    ap.add_argument("-o", "--out", default="preview_out")
    ap.add_argument("-n", "--num-batches", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv[1:])
    device = resolve_device(args.device)

    params = read_config(args.params)
    loader = SegmentedDataLoader("validate", params, num_workers=2, device=device)
    loader.set_epoch(0)
    ds, aug = loader.dataset, loader.augment

    os.makedirs(args.out, exist_ok=True)
    rng = np.random.default_rng(1000)
    it = batched(iter(loader.shuffler), loader.batch_size // 2)
    for b in range(args.num_batches):
        idx = next(it)
        x_org, x_aug = ds.get_batch(idx, False, rng)
        x_org = torch.from_numpy(x_org).to(device).float() / 32768
        x_aug = torch.from_numpy(x_aug).to(device).float() / 32768
        x_aug = aug.augment_waveform(x_aug, aug.draw(seeded_generator(777, 0, b), len(idx)))
        # interleave org/aug, peak-normalize each segment for listening
        wav = torch.stack([x_org, x_aug], dim=1).reshape(-1, ds.segment_size).cpu().numpy()
        wav = wav / np.maximum(np.abs(wav).max(axis=1, keepdims=True), 1e-9)
        out = os.path.join(args.out, "batch%d.wav" % b)
        write_wav(out, wav.reshape(-1)[: params["sample_rate"] * 30], params["sample_rate"])
        print("wrote", out)


if __name__ == "__main__":
    main()
