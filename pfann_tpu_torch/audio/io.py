"""Host-side audio I/O.

A copy of ``pfann_tpu/audio/io.py``, so that the port imports nothing of
the JAX package.

Parity target: reference datautil/audio.py — stdlib ``wave`` for WAV
(including WAVE_FORMAT_EXTENSIBLE and multi-channel files the stdlib
refuses, via a header-patching shim), 8/16/24-bit PCM decode, and an
ffmpeg subprocess fallback for everything else.  Decode is I/O-bound host
work and stays native-subprocess/numpy by design; nothing here touches
the accelerator.

Deviations from the reference:
  * ffmpeg decodes straight to s16le PCM via ffprobe metadata (one code
    path for both whole-file and streaming use) instead of piping a WAV
    container.
  * S3 support is gated on boto3 being importable.
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import wave

import numpy as np


class _PatchedFormatWave:
    """File-like wrapper that rewrites the wFormatTag field (bytes 20-21 of
    a canonical RIFF header) to 1 (PCM) so stdlib ``wave`` accepts
    WAVE_FORMAT_EXTENSIBLE and >2-channel files (cf. audio.py:13-25)."""

    def __init__(self, stream):
        self.stream = stream
        self.pos = 0

    def read(self, n: int) -> bytes:
        chunk = self.stream.read(n)
        start, end = self.pos, self.pos + len(chunk)
        self.pos = end
        if start < 22 and end > 20:  # overlap with bytes [20, 22)
            buf = bytearray(chunk)
            for off, b in ((20, 1), (21, 0)):
                if start <= off < end:
                    buf[off - start] = b
            chunk = bytes(buf)
        return chunk


def _decode_pcm(data: bytes, sampwidth: int, nchannels: int) -> np.ndarray:
    """PCM bytes -> float samples [C, N] in [-1, 1) (audio.py:49-66)."""
    if sampwidth == 1:
        samples = np.frombuffer(data, dtype=np.uint8).astype(np.float32) / 128 - 1
    elif sampwidth == 2:
        samples = np.frombuffer(data, dtype=np.int16).astype(np.float32) / 32768
    elif sampwidth == 3:
        raw = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
        # sign-extend 24-bit little-endian into int32
        as32 = (
            raw[:, 0].astype(np.int32)
            | (raw[:, 1].astype(np.int32) << 8)
            | (raw[:, 2].astype(np.int32) << 16)
        )
        as32 = np.where(as32 >= 1 << 23, as32 - (1 << 24), as32)
        samples = as32.astype(np.float32) / 8388608
    else:
        raise NotImplementedError("sample width %d" % sampwidth)
    return samples.reshape(-1, nchannels).T


def wave_get_audio(filename) -> tuple[np.ndarray, int] | None:
    with open(filename, "rb") as fin:
        w = wave.open(_PatchedFormatWave(fin))
        if w.getsampwidth() not in {1, 2, 3}:
            return None
        data = w.readframes(w.getnframes())
        return _decode_pcm(data, w.getsampwidth(), w.getnchannels()), w.getframerate()


def have_ffmpeg() -> bool:
    from shutil import which

    return which("ffmpeg") is not None and which("ffprobe") is not None


def ffprobe_info(filename) -> dict:
    out = subprocess.run(
        [
            "ffprobe", "-i", str(filename), "-show_streams", "-select_streams", "a",
            "-print_format", "json",
        ],
        capture_output=True,
        check=False,
    ).stdout
    prop = json.loads(out or b"{}")
    if "streams" not in prop or not prop["streams"]:
        raise RuntimeError("ffprobe cannot decode audio: %s" % filename)
    return prop["streams"][0]


def ffmpeg_get_audio(filename) -> tuple[np.ndarray, int]:
    """Decode any format to float samples [C, N] via ffmpeg s16le pipe."""
    info = ffprobe_info(filename)
    rate, ch = int(info["sample_rate"]), int(info["channels"])
    proc = subprocess.run(
        ["ffmpeg", "-i", str(filename), "-f", "s16le", "-acodec", "pcm_s16le", "pipe:1"],
        capture_output=True,
        check=False,
    )
    samples = np.frombuffer(proc.stdout, dtype=np.int16).astype(np.float32) / 32768
    n = samples.shape[0] // ch * ch
    return samples[:n].reshape(-1, ch).T, rate


def get_audio(filename) -> tuple[np.ndarray, int]:
    """(float samples [C, N], rate); WAV fast path, ffmpeg fallback,
    s3:// URLs downloaded to a temp file first (audio.py:68-75,155-170)."""
    if str(filename).startswith("s3://"):
        from pfann_tpu_torch.utils.config import download_tmp_from_s3

        tmpname = download_tmp_from_s3(str(filename))
        try:
            return get_audio(tmpname)
        finally:
            os.unlink(tmpname)
    if str(filename).endswith(".wav"):
        try:
            a = wave_get_audio(filename)
            if a is not None:
                return a
        except Exception:
            pass
    if have_ffmpeg():
        try:
            return ffmpeg_get_audio(filename)
        except Exception:
            print("failed to decode %s. maybe the file is broken!" % filename)
            return np.zeros([1, 0], dtype=np.float32), 44100
    raise RuntimeError(
        "cannot decode %s: not a readable WAV and ffmpeg is unavailable" % filename
    )


def write_wav(filename, samples: np.ndarray, rate: int) -> None:
    """Write float samples ([N] or [C, N], clipped to [-1, 1]) as 16-bit
    PCM WAV."""
    samples = np.asarray(samples)
    if samples.ndim == 1:
        samples = samples[None, :]
    quantized = np.clip(samples * 32768, -32768, 32767).astype(np.int16)
    with wave.open(str(filename), "wb") as w:
        w.setnchannels(quantized.shape[0])
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(quantized.T.tobytes())
