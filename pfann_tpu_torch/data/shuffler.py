"""Two-stage chunked shuffler (a copy of ``pfann_tpu/data/shuffler.py``).

Parity target: reference datautil/dataset_v2.py:191-265 — shuffle the song
list, split into chunks of ``shuffle_size`` songs, then shuffle segments
within each chunk.  This trades global shuffle quality for sequential disk
reads on the segment cache (the thesis ablates shuffle_size 1/10/100/1000).
Per-epoch determinism: both generators are seeded 42 + epoch
(dataset_v2.py:200-202).

``shuffle_size=None`` degrades to a full random permutation
(dataset_v2.py:212-218).
"""

from __future__ import annotations

from typing import Iterable, Iterator, Sequence

import numpy as np


class TwoStageShuffler:
    def __init__(
        self,
        num_items: int,
        shuffle_size: int | None = None,
        song_ranges: Sequence[tuple[int, int]] | None = None,
    ):
        """song_ranges: per-song (first_segment_idx, end_segment_idx); only
        needed for the two-stage mode."""
        self.num_items = num_items
        self.shuffle_size = shuffle_size
        self.song_ranges = song_ranges
        self.shuffle = True
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return self.num_items

    def __iter__(self) -> Iterator[int]:
        if not self.shuffle:
            return iter(range(self.num_items))
        rng = np.random.default_rng(42 + self.epoch)
        rng2 = np.random.default_rng(42 + self.epoch)
        if self.shuffle_size is None or self.song_ranges is None:
            return iter(rng.permutation(self.num_items).tolist())
        return self._two_stage(rng, rng2)

    def _two_stage(self, rng, rng2) -> Iterator[int]:
        n_songs = len(self.song_ranges)
        shuffled_songs = rng.permutation(n_songs)
        for c in range(0, n_songs, self.shuffle_size):
            chunk = np.sort(shuffled_songs[c : c + self.shuffle_size])
            buf: list[int] = []
            for song in chunk.tolist():
                start, end = self.song_ranges[song]
                buf.extend(range(start, end))
            order = rng2.permutation(len(buf))
            for i in order:
                yield buf[i]


def batched(it: Iterable[int], batch: int, drop_last: bool = False):
    """BatchSampler equivalent (dataset_v2.py:275: batch_size // 2 segment
    indices per batch, keep the final partial batch)."""
    buf: list[int] = []
    for x in it:
        buf.append(x)
        if len(buf) == batch:
            yield buf
            buf = []
    if buf and not drop_last:
        yield buf
