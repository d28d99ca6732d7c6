"""Batched constellation extraction for the landmark system, in torch ops.

The port of ``pfann_tpu/landmark/device.py``.  The landmark front end
(log-STFT -> local max -> median gate, core.py:51-78) runs on the device
for a BATCH of songs per call and returns the peak constellations; hash
pairing stays on the host (``core.pair_peaks``).  No Pallas kernel lies
behind it in the JAX package (an XLA program there), and none is written
here: framing, ``torch.fft.rfft``, ``F.max_pool2d`` and ``torch.sort``.

Numerical contract against the numpy reference (core.spectrogram /
core.find_peaks), as in the JAX module:

  * audio enters as int16 (the WAV decoder's samples) and is scaled by
    1/32768 on the device, a power-of-2 divide, so the f32 frames are
    bit-identical to the host pipeline's; float inputs ride as f32;
  * the local-max test is ``spec == max_pool2d(spec)`` with the pool's
    implicit -inf padding, which equals scipy's
    maximum_filter(mode="nearest") for a max filter: a centred window
    that straddles the border holds the border cell itself, so
    replicating it never changes the max;
  * the median is the mean of the two middle order statistics of each
    song's valid cells (numpy's convention; ``torch.median`` returns the
    lower one, and ``torch.quantile`` refuses inputs above 2**24 cells);
  * the FFT is the one inexact step: cuFFT and pocketfft differ in ulps,
    so a cell within float noise of the ``median + MIN_GAIN`` gate (or of
    a neighbour's maximum) can flip.  On the CPU, torch's rfft and
    numpy's give the same peaks on the test signals.

Staging: int16 audio in, bit-packed peak masks out (spec.size/8 bytes per
song).  On CUDA each chunk is staged in pinned host memory and copied
with ``non_blocking``; up to ``pipeline`` chunks are in flight, and the
drain's device-to-host copy into pinned memory is the one sync point.
A chunk's host buffers stay referenced until its drain, so none is reused
while its copy may still be in flight.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from pfann_tpu_torch.utils.device import resolve_device
from pfann_tpu_torch.utils.fastcast import int16_if_exact as as_device_input
from .core import HOP, MIN_GAIN, N_FFT, NEIGH_F, NEIGH_T

N_BINS = N_FFT // 2 + 1
_BITS = (128, 64, 32, 16, 8, 4, 2, 1)  # np.unpackbits order: MSB first

__all__ = ["DevicePeakExtractor", "as_device_input", "log_spectrogram", "peak_mask"]


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def log_spectrogram(audio: torch.Tensor) -> torch.Tensor:
    """[B, L] int16 or float32 audio (L a multiple of HOP) -> log-magnitude
    STFT [B, T, N_BINS] f32, T = L / HOP - 3 frames: int16 scaled by
    1/32768, hop-reshape framing, Hann window, rfft, log(|X| + 1e-6)."""
    x = audio.float() / 32768.0 if audio.dtype == torch.int16 else audio
    B, L = x.shape
    T = L // HOP - (N_FFT // HOP - 1)
    # frames[b, t] = hops[b, t : t + 4]
    hops = x.reshape(B, L // HOP, HOP)
    frames = torch.cat([hops[:, i : i + T] for i in range(N_FFT // HOP)], dim=2)
    win = torch.from_numpy(np.hanning(N_FFT).astype(np.float32)).to(x.device)
    return torch.log(torch.fft.rfft(frames * win, dim=2).abs() + 1e-6)


def peak_mask(audio: torch.Tensor, valid_frames: torch.Tensor) -> torch.Tensor:
    """[B, L] audio, valid_frames [B] int32 -> packed peak mask
    [B, N_BINS, ceil(T/8)] uint8, bit-packed along time MSB first.  The
    counterpart of ``DevicePeakExtractor._make_fn`` in the JAX module."""
    spec = log_spectrogram(audio)
    B, T, Fb = spec.shape
    tmask = (torch.arange(T, device=spec.device)[None, :] < valid_frames[:, None])[:, :, None]
    spec = torch.where(tmask, spec, float("-inf"))
    # local max over (time NEIGH_T, freq NEIGH_F); -inf padding
    mx = F.max_pool2d(spec[:, None], (NEIGH_T, NEIGH_F), stride=1,
                      padding=(NEIGH_T // 2, NEIGH_F // 2))[:, 0]
    # median over each song's valid cells: +inf fill sorts them last
    srt = torch.sort(torch.where(tmask, spec, float("inf")).reshape(B, -1), dim=1).values
    n_valid = valid_frames.long() * Fb
    lo = srt.gather(1, ((n_valid - 1) // 2)[:, None])
    hi = srt.gather(1, (n_valid // 2)[:, None])
    gate = ((lo + hi) / 2 + MIN_GAIN)[:, :, None]
    mask = (spec == mx) & (spec > gate)  # [B, T, F]
    Tp = _ceil_to(T, 8)
    mask = F.pad(mask.transpose(1, 2).to(torch.uint8), (0, Tp - T))
    bits = torch.tensor(_BITS, dtype=torch.uint8, device=spec.device)
    return (mask.reshape(B, Fb, Tp // 8, 8) * bits).sum(dim=3, dtype=torch.uint8)


class DevicePeakExtractor:
    """Batched spectrogram + constellation extraction on ``device``.

    extract(wavs) -> list of peak arrays [(f, t)] int32, time-sorted: the
    return contract of core.find_peaks(core.spectrogram(wav)).  ``device``
    defaults to cuda, which raises where no card is visible.
    """

    def __init__(self, batch: int = 32, pipeline: int = 4,
                 device: str | torch.device = "cuda"):
        self.batch = batch
        # chunks in flight before the oldest is drained
        self.pipeline = max(1, pipeline)
        self.device = resolve_device(str(device))

    def _bucket(self, n_frames: int) -> int:
        """Frame-count bucket: multiples of 64 frames (~2 s) bound the
        number of distinct shapes while wasting < 2 s of padded work."""
        return max(_ceil_to(n_frames, 64), 64)

    def extract(self, wavs: list[np.ndarray]) -> list[np.ndarray]:
        """Peak constellations for a list of mono signals (int16 or
        float32; int16 halves the copied bytes and scales exactly).
        Signals shorter than N_FFT take the host path's zero pad."""
        out: list[np.ndarray | None] = [None] * len(wavs)
        jobs = []  # (orig_i, wav, n_frames)
        for i, w in enumerate(wavs):
            w = np.asarray(w).reshape(-1)
            if w.shape[0] < N_FFT:
                w = np.pad(w, (0, N_FFT - w.shape[0]))
            jobs.append((i, w, 1 + (w.shape[0] - N_FFT) // HOP))
        # chunks of similar length share a frame bucket
        jobs.sort(key=lambda j: j[2])
        pending = []
        for at in range(0, len(jobs), self.batch):
            chunk = jobs[at : at + self.batch]
            pending.append((chunk, self._dispatch_chunk(chunk)))
            if len(pending) >= self.pipeline:
                self._drain_chunk(*pending.pop(0), out)
        while pending:
            self._drain_chunk(*pending.pop(0), out)
        return out  # type: ignore[return-value]

    def stage_chunk(self, chunk) -> tuple[torch.Tensor, torch.Tensor]:
        """Host buffers of a chunk: audio [B, L] (int16 when every member
        is int16, else f32 with int16 members rescaled here) and
        valid_frames [B] int32; pinned when the device is CUDA."""
        B = len(chunk)
        Tb = self._bucket(max(j[2] for j in chunk))
        L = (Tb + (N_FFT // HOP - 1)) * HOP
        all_i16 = all(j[1].dtype == np.int16 for j in chunk)
        pin = self.device.type == "cuda"
        buf = torch.zeros((B, L), dtype=torch.int16 if all_i16 else torch.float32,
                          pin_memory=pin)
        valid = torch.zeros(B, dtype=torch.int32, pin_memory=pin)
        host, host_valid = buf.numpy(), valid.numpy()
        for b, (_, w, nf) in enumerate(chunk):
            # clip to the bucketed buffer: when nf == Tb, samples past the
            # last complete frame overrun L; they belong to no frame
            n = min(w.shape[0], L)
            if all_i16:
                host[b, :n] = w[:n]
            elif w.dtype == np.int16:
                # the f32 carrier is not rescaled on the device
                host[b, :n] = w[:n].astype(np.float32) / 32768.0
            else:
                host[b, :n] = w[:n].astype(np.float32)
            host_valid[b] = nf
        return buf, valid

    def _dispatch_chunk(self, chunk):
        """Stage a chunk and launch its device work; returns (host
        buffers, un-synced packed mask).  The host buffers ride along to
        the drain, so their pinned memory outlives the async copy."""
        buf, valid = self.stage_chunk(chunk)
        packed = peak_mask(buf.to(self.device, non_blocking=True),
                           valid.to(self.device, non_blocking=True))
        return (buf, valid), packed

    def _drain_chunk(self, chunk, dispatched, out) -> None:
        _, packed = dispatched
        if self.device.type == "cuda":
            host = torch.empty(packed.shape, dtype=torch.uint8, pin_memory=True)
            host.copy_(packed, non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()  # the one sync point
        else:
            host = packed
        host = host.numpy()
        for b, (i, _, nf) in enumerate(chunk):
            mask = np.unpackbits(host[b], axis=1)[:, :nf].astype(bool)
            f, t = np.nonzero(mask)  # row-major == find_peaks' nonzero
            order = np.argsort(t, kind="stable")
            out[i] = np.stack([f[order], t[order]], axis=1).astype(np.int32)
