"""Mock spectrogram data loader — train with zero datasets (a copy of
``pfann_tpu/data/mock.py``: the same seeds give the same bytes).

Parity target: reference datautil/mock_data.py:5-60 — random spectrogram
(org, aug) pairs at 1/50 of the real dataset sizes, wired through the same
shuffler/batch plumbing, enabled by ``train.py --mock``.

``configs['mock_sizes']`` = [train_N, val_N] overrides the defaults (used
by tests to keep things tiny).

``part = (rank, world_size)`` (set by a data-parallel trainer) makes each
batch the rank's block of the global batch's interleaved rows, with the
global row count: (rows [r1 - r0, F, T], 2 * pairs); only those pairs are
read.
"""

from __future__ import annotations

from typing import Any, Iterator

import numpy as np

from pfann_tpu_torch.data.shuffler import TwoStageShuffler, batched
from pfann_tpu_torch.parallel.mesh import pair_block


def make_false_data(rng: np.random.Generator, N: int, F: int, T: int) -> np.ndarray:
    """Pairs [N, 2, F, T]: aug = org + U(-0.5, 0.5) (mock_data.py:5-9)."""
    mock = rng.random((N, F, T), dtype=np.float32)
    mock2 = mock + rng.random((N, F, T), dtype=np.float32) - 0.5
    return np.stack([mock, mock2], axis=1)


class MockedDataLoader:
    def __init__(self, train_val: str, configs: dict[str, Any], num_workers: int = 0):
        assert train_val in {"train", "validate"}
        F = configs["n_mels"]
        segn = int(configs["segment_size"] * configs["sample_rate"])
        T = (segn + configs["stft_hop"] - 1) // configs["stft_hop"]
        sizes = configs.get("mock_sizes", [584183 // 50, 29215 // 50])
        N = sizes[0] if train_val == "train" else sizes[1]
        seed = 123 if train_val == "train" else 456
        self.dataset = make_false_data(np.random.default_rng(seed), N, F, T)
        assert configs["batch_size"] % 2 == 0
        self.batch_size = configs["batch_size"]
        self.shuffler = TwoStageShuffler(N, None)
        self.shuffle = True
        self.augmented = True
        self.eval_time_shift = False
        self.part: tuple[int, int] | None = None

    def set_epoch(self, epoch: int) -> None:
        self.shuffler.set_epoch(epoch)

    def __iter__(self) -> Iterator[np.ndarray]:
        self.shuffler.shuffle = self.shuffle
        for idx in batched(iter(self.shuffler), self.batch_size // 2):
            if self.part is None:
                yield self.dataset[np.asarray(idx)]
                continue
            p0, p1, lo, hi = pair_block(len(idx), *self.part)
            pairs = self.dataset[np.asarray(idx[p0:p1], dtype=np.int64)]
            yield pairs.reshape((-1,) + pairs.shape[2:])[lo:hi], 2 * len(idx)

    def __len__(self) -> int:
        return -(-len(self.dataset) // (self.batch_size // 2))
