"""Streaming audio ingestion: bounded-memory decode + resample.

A copy of ``pfann_tpu/audio/stream.py``, so that the port imports
nothing of the JAX package.

Parity target: the reference's generator-based chunk readers
(datautil/audio.py:77-153, WaveStream/FfmpegStream) feeding a 60 s-window
chunked resample with overlap trimming (datautil/musicdata.py:28-66).
For fma_full-scale DB builds (tracks up to 3600 s) whole-file decode at
the source rate costs ~1 GB+ of host RAM per worker; streaming keeps the
source-rate footprint at one block.

Design differences from the reference:
  * :func:`stream_resample` emits blocks that are **bitwise identical**
    to a whole-file ``scipy.signal.resample_poly`` call: block boundaries
    are kept on multiples of the decimation factor so the polyphase
    output grid stays aligned, and each block carries enough context to
    cover the FIR support — so streaming vs whole-file can never change
    embeddings.  (The reference's julius chunking trims a heuristic
    half-second and is *not* sample-exact at block seams.)
  * Wave streaming handles 8/16/24-bit PCM (the reference's WaveStream
    supports 16-bit only).
"""

from __future__ import annotations

import math
import subprocess
import wave
from typing import Iterator

import numpy as np
from scipy.signal import resample_poly

from pfann_tpu_torch.audio.io import (
    _decode_pcm,
    _PatchedFormatWave,
    ffprobe_info,
    have_ffmpeg,
)


class WaveChunkReader:
    """Chunked reader over a (possibly WAVE_FORMAT_EXTENSIBLE) WAV file."""

    def __init__(self, filename):
        self._fh = open(filename, "rb")
        try:
            self._wave = wave.open(_PatchedFormatWave(self._fh))
        except Exception:
            self._fh.close()
            raise
        self.rate = self._wave.getframerate()
        self.channels = self._wave.getnchannels()
        self._width = self._wave.getsampwidth()
        if self._width not in {1, 2, 3}:
            self._fh.close()
            raise NotImplementedError("sample width %d" % self._width)

    def chunks(self, n_frames: int) -> Iterator[np.ndarray]:
        """Yields float32 [C, <=n_frames] until EOF."""
        while True:
            data = self._wave.readframes(n_frames)
            if not data:
                break
            yield _decode_pcm(data, self._width, self.channels)
            if len(data) < n_frames * self._width * self.channels:
                break

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class FfmpegChunkReader:
    """Chunked reader over an ffmpeg s16le decode pipe (any format)."""

    def __init__(self, filename):
        info = ffprobe_info(filename)
        self.rate = int(info["sample_rate"])
        self.channels = int(info["channels"])
        self._proc = subprocess.Popen(
            ["ffmpeg", "-i", str(filename), "-f", "s16le",
             "-acodec", "pcm_s16le", "pipe:1"],
            stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL,
            stdin=subprocess.DEVNULL,
        )

    def chunks(self, n_frames: int) -> Iterator[np.ndarray]:
        frame_bytes = 2 * self.channels
        while True:
            data = self._proc.stdout.read(n_frames * frame_bytes)
            usable = len(data) // frame_bytes * frame_bytes
            if usable:
                yield _decode_pcm(data[:usable], 2, self.channels)
            if len(data) < n_frames * frame_bytes:
                break

    def close(self) -> None:
        self._proc.terminate()
        self._proc.communicate()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def open_stream(filename):
    """WAV fast path, ffmpeg fallback (mirrors io.get_audio's policy)."""
    if str(filename).endswith(".wav"):
        try:
            return WaveChunkReader(filename)
        except Exception:
            pass
    if have_ffmpeg():
        return FfmpegChunkReader(filename)
    raise RuntimeError(
        "cannot stream %s: not a readable WAV and ffmpeg is unavailable"
        % filename
    )


def stream_resample(
    chunks: Iterator[np.ndarray],
    orig_sr: int,
    new_sr: int,
    block_seconds: float = 30.0,
) -> Iterator[np.ndarray]:
    """Resample a stream of float arrays [..., n] along the last axis.

    The concatenated output is bitwise identical to
    ``resample_poly(whole_signal, up, down)``: emission regions start on
    multiples of ``down`` (so every emitted sample sits on the global
    polyphase output grid) and carry ``ctx`` input samples of context on
    each side — more than the Kaiser FIR's input-side support — so each
    output sample sees exactly the taps it would in a whole-file call.
    Peak memory is one block + context at the source rate.
    """
    if orig_sr == new_sr:
        for c in chunks:
            yield np.asarray(c, dtype=np.float32)
        return

    g = math.gcd(int(orig_sr), int(new_sr))
    up, down = new_sr // g, orig_sr // g
    half_len = 10 * max(up, down)  # scipy's kaiser FIR half length (up-grid)
    ctx = -(-(half_len // up + 2) // down) * down  # input samples, %down==0
    L = max(int(block_seconds * orig_sr) // down, 1) * down

    def out_idx(i: int) -> int:  # input index (multiple of down) -> output
        return i * up // down

    buf: np.ndarray | None = None
    base = 0  # global input index of buf[..., 0]; always a multiple of down
    done = 0  # global input index already emitted; multiple of down

    def emit(upto: int):
        # interior block: both edges carry >= ctx samples of real context,
        # so the FIR sees exactly the taps of a whole-file call.  The true
        # signal tail is handled separately below (scipy's own edge
        # zero-padding there matches the whole-file call).
        nonlocal buf, base, done
        s = max(done - ctx, 0)
        lo, hi = out_idx(done) - out_idx(s), out_idx(upto) - out_idx(s)
        piece = buf[..., s - base : upto + ctx - base]
        res = resample_poly(
            np.asarray(piece, dtype=np.float32), up, down, axis=-1
        ).astype(np.float32)
        out = res[..., lo:hi]
        done = upto
        keep = max(done - ctx, 0)
        buf = buf[..., keep - base :]
        base = keep
        return out

    for c in chunks:
        c = np.asarray(c, dtype=np.float32)
        buf = c if buf is None else np.concatenate([buf, c], axis=-1)
        while base + buf.shape[-1] >= done + L + ctx:
            yield emit(done + L)
    if buf is None:
        return
    total = base + buf.shape[-1]
    if total > done or done == 0:
        # final block: scipy's own zero-padding at the true signal edge
        # matches the whole-file call exactly
        n_out_total = -(-total * up // down)
        s = max(done - ctx, 0)
        res = resample_poly(
            np.asarray(buf[..., s - base :], dtype=np.float32), up, down,
            axis=-1,
        ).astype(np.float32)
        lo = out_idx(done) - out_idx(s)
        yield res[..., lo : lo + (n_out_total - out_idx(done))]


def stream_audio_resampled(
    filename,
    target_rate: int,
    chunk_seconds: float = 10.0,
    block_seconds: float = 30.0,
) -> tuple[np.ndarray, int]:
    """Decode + resample a file with bounded source-rate memory.

    Returns (float32 [C, N] at target_rate, source_rate).  The result is
    bitwise identical to ``resample(get_audio(f)[0], src, target)``; only
    the peak RSS differs (one source-rate block instead of the file).
    """
    with open_stream(filename) as reader:
        n = max(int(reader.rate * chunk_seconds), 1)
        pieces = list(
            stream_resample(
                reader.chunks(n), reader.rate, target_rate, block_seconds
            )
        )
        if not pieces:
            return np.zeros((reader.channels, 0), np.float32), reader.rate
        return np.concatenate(pieces, axis=-1), reader.rate
