"""Train the fingerprinter on the port.

    python -m pfann_tpu_torch.train -p configs/default.json [-w 4] [--mock] \
        [--dp] [--device cuda|cpu]

The argv of the JAX ``train.py`` (reference train.py:264-278) plus
``--device``: ``cuda`` (the default) raises where no card is visible, and
``cpu`` runs the same code on the CPU.  ``--mock`` trains on random
spectrogram pairs; otherwise the real segment loader reads the config's
corpus, with noise and impulse-response augmentation on the device.
``--dp`` trains on the one visible card, as the JAX CLI does on one
device; data parallelism over several cards waits for ROADMAP 1.16, so it
raises where more than one card is visible.
"""

import argparse
import sys

import torch

from pfann_tpu_torch.data.mock import MockedDataLoader
from pfann_tpu_torch.data.segments import SegmentedDataLoader
from pfann_tpu_torch.train.trainer import Trainer
from pfann_tpu_torch.utils.config import read_config
from pfann_tpu_torch.utils.device import resolve_device
from pfann_tpu_torch.utils.logging import MultiProcessInitLogger, get_logger


def main(argv: list[str] | None = None) -> None:
    argv = list(sys.argv if argv is None else argv)
    MultiProcessInitLogger("train")()
    logger = get_logger()
    logger.info("logger init")

    ap = argparse.ArgumentParser(prog="python -m pfann_tpu_torch.train")
    ap.add_argument("-p", "--params", default="configs/default.json")
    ap.add_argument("-w", "--workers", type=int, default=4)
    ap.add_argument("--mock", action="store_true")
    ap.add_argument("--dp", action="store_true",
                    help="data-parallel over all visible cards (one card today)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv[1:])
    logger.info(args)
    device = resolve_device(args.device)

    params = read_config(args.params)
    if args.dp:
        n = torch.cuda.device_count() if device.type == "cuda" else 1
        rows = 2 * params["batch_size"]
        if rows % n:
            raise SystemExit(
                "--dp needs 2*batch_size (%d) divisible by the card count (%d)" % (rows, n)
            )
        if n > 1:
            raise SystemExit(
                "--dp over %d cards: multi-card data parallelism waits for ROADMAP "
                "1.16; make one card visible (CUDA_VISIBLE_DEVICES)" % n
            )
        logger.info("--dp on one card: training on %s; multi-card data parallelism "
                    "waits for ROADMAP 1.16", device)

    if args.mock:
        train_data = MockedDataLoader("train", params, num_workers=args.workers)
        val_data = MockedDataLoader("validate", params, num_workers=args.workers)
    else:
        train_data = SegmentedDataLoader("train", params, args.workers, device)
        val_data = SegmentedDataLoader("validate", params, args.workers, device)
    print("training data contains %d samples" % len(train_data.dataset))
    val_data.shuffle = False
    val_data.eval_time_shift = True
    print("validation data contains %d samples" % len(val_data.dataset))

    trainer = Trainer(params, device=device)
    trainer.fit(train_data, val_data, config_path=args.params)


if __name__ == "__main__":
    main()
