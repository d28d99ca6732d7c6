"""Train the fingerprinter on the port.

    python -m pfann_tpu_torch.train -p configs/default.json [-w 4] [--mock] \
        [--dp] [--device cuda|cpu]

The argv of the JAX ``train.py`` (reference train.py:264-278) plus
``--device``: ``cuda`` (the default) raises where no card is visible, and
``cpu`` runs the same code on the CPU.  ``--mock`` trains on random
spectrogram pairs; otherwise the real segment loader reads the config's
corpus, with noise and impulse-response augmentation on the device.
``--dp`` trains data-parallel, one process (rank) per visible card in an
NCCL group, each rank with its block of every global batch (the JAX CLI's
mesh over all devices); with ``--device cpu``, one gloo rank.
"""

import argparse
import sys

import torch
import torch.distributed as dist

from pfann_tpu_torch.data.mock import MockedDataLoader
from pfann_tpu_torch.data.segments import SegmentedDataLoader
from pfann_tpu_torch.parallel.mesh import init_data_parallel, spawn_ranks
from pfann_tpu_torch.train.trainer import Trainer
from pfann_tpu_torch.utils.config import read_config
from pfann_tpu_torch.utils.device import resolve_device
from pfann_tpu_torch.utils.logging import MultiProcessInitLogger, get_logger


def train(params_path: str, workers: int, mock: bool, device: torch.device,
          group=None) -> None:
    """Build the loaders on ``device`` and fit (rank 0 alone prints)."""
    params = read_config(params_path)
    lead = group is None or dist.get_rank(group) == 0
    if mock:
        train_data = MockedDataLoader("train", params, num_workers=workers)
        val_data = MockedDataLoader("validate", params, num_workers=workers)
    else:
        train_data = SegmentedDataLoader("train", params, workers, device)
        val_data = SegmentedDataLoader("validate", params, workers, device)
    if lead:
        print("training data contains %d samples" % len(train_data.dataset))
    val_data.shuffle = False
    val_data.eval_time_shift = True
    if lead:
        print("validation data contains %d samples" % len(val_data.dataset))
    trainer = Trainer(params, device=device, group=group)
    trainer.fit(train_data, val_data, config_path=params_path)


def train_rank(rank: int, world_size: int, port: int, params_path: str, workers: int,
               mock: bool, device_type: str) -> None:
    """One rank of ``--dp``: card ``rank`` (NCCL) or the CPU (gloo)."""
    MultiProcessInitLogger("train")()
    device = torch.device(device_type, rank) if device_type == "cuda" else torch.device("cpu")
    init_data_parallel(rank, world_size, port, device=device)
    try:
        train(params_path, workers, mock, device, group=dist.group.WORLD)
    finally:
        dist.destroy_process_group()


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
                    help="data-parallel over all visible cards (one rank each)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv[1:])
    logger.info(args)
    device = resolve_device(args.device)

    if not args.dp:
        train(args.params, args.workers, args.mock, device)
        return
    n = torch.cuda.device_count() if device.type == "cuda" else 1
    rows = 2 * read_config(args.params)["batch_size"]
    if rows % n:
        raise SystemExit(
            "--dp needs 2*batch_size (%d) divisible by the device count (%d)" % (rows, n)
        )
    print("data-parallel over %d devices" % n, flush=True)
    # the rank entry by its module's own name, so a spawned rank imports it
    # (this file runs as __main__ under python -m)
    from pfann_tpu_torch.train.__main__ import train_rank as entry

    spawn_ranks(entry, n, args=(args.params, args.workers, args.mock, device.type))


if __name__ == "__main__":
    main()
