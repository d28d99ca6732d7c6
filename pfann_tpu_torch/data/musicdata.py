"""Inference-time music dataset: file -> overlapping query/DB segments.

A copy of ``pfann_tpu/data/musicdata.py``, so that the port imports
nothing of the JAX package.

Parity target: reference datautil/musicdata.py:12-104 —
  * streamed decode + chunked resample to the model rate with bounded
    source-rate memory (julius' 60 s overlap-trimmed windows,
    musicdata.py:28-66, replaced by the sample-exact block resampler in
    audio/stream.py — 1 h tracks never hold source-rate audio
    for more than one block)
  * fake-stereo (opposite-phase) detection before the mono mixdown
    (musicdata.py:74-80)
  * pad short files to one segment
  * unfold into overlapping segments with hop = hop_size /
    frame_shift_mul, then de-mean per segment (musicdata.py:82-88)
  * per-file exceptions yield an empty [0, segment] array so one broken
    file cannot kill a batch run (musicdata.py:95-101)
"""

from __future__ import annotations

import collections
import concurrent.futures
from typing import Any, Iterator

import numpy as np

from pfann_tpu_torch.audio.io import get_audio
from pfann_tpu_torch.audio.resample import resample
from pfann_tpu_torch.utils.config import read_file_list
from pfann_tpu_torch.utils.logging import get_logger


def unfold(wav: np.ndarray, size: int, hop: int) -> np.ndarray:
    """Sliding windows [n, size] (torch.unfold semantics: only complete
    windows)."""
    n = (wav.shape[-1] - size) // hop + 1
    if n <= 0:
        return np.zeros((0, size), dtype=wav.dtype)
    idx = np.arange(n)[:, None] * hop + np.arange(size)[None, :]
    return wav[idx]


class MusicDataset:
    def __init__(self, file_list: str, params: dict[str, Any]):
        self.params = params
        self.sample_rate = params["sample_rate"]
        self.segment_size = int(self.sample_rate * params["segment_size"])
        self.hop_size = int(self.sample_rate * params["hop_size"])
        self.frame_shift_mul = params["indexer"].get("frame_shift_mul", 1)
        self.files = read_file_list(file_list)

    def load(self, index: int) -> tuple[int, str, np.ndarray]:
        try:
            return self._unsafe_load(index)
        except Exception as x:
            get_logger().exception(x)
            return index, self.files[index], np.zeros(
                (0, self.segment_size), dtype=np.float32
            )

    def _unsafe_load(self, index: int) -> tuple[int, str, np.ndarray]:
        _, name, wav = self._load_mono(index)
        segments = unfold(
            wav, self.segment_size, self.hop_size // self.frame_shift_mul
        )
        segments = segments - segments.mean(axis=1, keepdims=True)
        return index, self.files[index], segments.astype(np.float32)

    # -------------------------------------------------- raw (packed) path
    def load_raw(self, index: int) -> tuple[int, str, np.ndarray, int]:
        """Like :meth:`load` but stops BEFORE the unfold: returns
        (index, name, mono signal, n_segments).  The overlap expansion
        (2x bytes at hop = segment/2) and the per-segment de-mean happen
        on device (Embedder.embed_songs) — raw audio is what crosses the
        slow host->device boundary, as int16 when that is exact
        (utils/fastcast.int16_if_exact).  Errors return a zero-length
        signal and n_segments 0 (the builder's error-row contract)."""
        try:
            _, name, wav = self._load_mono(index)
        except Exception as x:
            get_logger().exception(x)
            return index, self.files[index], np.zeros(0, np.float32), 0
        from pfann_tpu_torch.utils.fastcast import int16_if_exact

        hop = self.hop_size // self.frame_shift_mul
        n = (wav.shape[0] - self.segment_size) // hop + 1
        return index, name, int16_if_exact(wav), n

    def _load_mono(self, index: int) -> tuple[int, str, np.ndarray]:
        """Decode + resample + fake-stereo fix + mono + min-length pad —
        the shared front of load()/load_raw()."""
        logger = get_logger()
        logger.info("MusicDataset getitem %s", self.files[index])
        name = self.files[index]
        if name.startswith("s3://") or not self.params.get("streaming", True):
            # s3 objects are downloaded whole anyway; and "streaming":
            # false is an escape hatch
            wav, smprate = get_audio(name)
            wav = resample(wav, smprate, self.sample_rate)
        else:
            from pfann_tpu_torch.audio.stream import stream_audio_resampled

            wav, _ = stream_audio_resampled(name, self.sample_rate)

        # fake stereo with opposite phase (musicdata.py:74-80)
        if wav.shape[0] == 2:
            pow1 = float(np.mean((wav[0] - wav[1]) ** 2))
            pow2 = float(np.mean((wav[0] + wav[1]) ** 2))
            if pow1 > pow2 * 1000:
                logger.warning(
                    "fake stereo with opposite phase detected: %s", self.files[index]
                )
                wav[1] *= -1
        wav = wav.mean(axis=0)

        if wav.shape[0] < self.segment_size:
            wav = np.pad(wav, (0, self.segment_size - wav.shape[0]))
        return index, name, wav

    def __len__(self) -> int:
        return len(self.files)

    def __iter__(self) -> Iterator[tuple[int, str, np.ndarray]]:
        return self.iterate()

    def _bounded_map(self, fn, num_workers: int, prefetch: int | None):
        """Thread-prefetched in-order map with BACKPRESSURE: at most
        `prefetch` decoded items in flight.  ex.map schedules the whole
        corpus eagerly — 20k songs of decoded audio buffered in RAM —
        because its workers never wait for the consumer."""
        window = prefetch or 4 * num_workers
        with concurrent.futures.ThreadPoolExecutor(
            max_workers=num_workers
        ) as ex:
            futs = collections.deque()
            nxt = 0
            n = len(self)
            while nxt < min(window, n):
                futs.append(ex.submit(fn, nxt))
                nxt += 1
            while futs:
                yield futs.popleft().result()
                if nxt < n:
                    futs.append(ex.submit(fn, nxt))
                    nxt += 1

    def iterate(self, num_workers: int = 0, prefetch: int | None = None):
        """Sequential or thread-prefetched iteration (the reference uses
        DataLoader worker processes; decode here is subprocess/C-bound so
        threads suffice)."""
        if num_workers <= 0:
            for i in range(len(self)):
                yield self.load(i)
        else:
            yield from self._bounded_map(self.load, num_workers, prefetch)

    def iterate_raw(self, num_workers: int = 0, prefetch: int | None = None):
        """iterate() for the packed (device-unfold) pipeline.  The
        default 4*num_workers window is sized in SONGS; embed_stream's
        dispatch batches are ~34 songs, so pass prefetch >= 2 batches
        for full decode/RTT overlap on long corpora."""
        if num_workers <= 0:
            for i in range(len(self)):
                yield self.load_raw(i)
        else:
            yield from self._bounded_map(
                self.load_raw, num_workers, prefetch
            )
