"""Waveform -> fingerprint embedding pipeline (port of
``pfann_tpu/index/embedder.py``).

Mel front-end and encoder run as one call per chunk on the chosen device.
PyTorch has no recompile cost, so chunks are NOT padded to fixed shapes
(the JAX package pads to ``bucket_tail_rows`` to reuse compiled
programs): every call runs on exactly the rows it was given.  Each row's
embedding does not depend on the rows batched with it.

``embed_with_saliency`` is JAX's ``jax.vjp`` through the model as
``torch.autograd.grad`` with the embedding itself as the cotangent.
"""

from __future__ import annotations

import collections
import time
from typing import Any

import numpy as np
import torch

from pfann_tpu_torch.models.fp_network import build_fp_network
from pfann_tpu_torch.ops.melspec import build_mel_spec_layer
from pfann_tpu_torch.utils import checkpoint as ckpt


class Embedder:
    def __init__(
        self,
        params: dict[str, Any],
        model_path: str,
        device: torch.device | str,
        compute_dtype: torch.dtype = torch.bfloat16,
        chunk: int = 512,
    ):
        self.device = torch.device(device)
        self.model = build_fp_network(params, compute_dtype=compute_dtype)
        self.model.load_state_dict(ckpt.load_model(model_path))
        self.model.to(self.device).eval().requires_grad_(False)
        self.mel = build_mel_spec_layer(params).to(self.device)
        self.chunk = chunk
        self.d = self.model.d
        self.segment_size = int(params["segment_size"] * params["sample_rate"])

    @torch.inference_mode()
    def _embed_frames(self, frames: torch.Tensor) -> torch.Tensor:
        """[n, segment_size] f32 on device -> [n, d] f32 L2-normalized."""
        return self.model(self.mel(frames), norm=True)

    def embed(self, wav: np.ndarray) -> np.ndarray:
        """wav: [S, segment_size] float32 -> [S, d] float32 L2-normalized."""
        if wav.shape[0] == 0:
            return np.zeros((0, self.d), dtype=np.float32)
        outs = [
            self._embed_frames(torch.from_numpy(
                np.ascontiguousarray(wav[i : i + self.chunk], np.float32)
            ).to(self.device))
            for i in range(0, wav.shape[0], self.chunk)
        ]
        return torch.cat(outs).cpu().numpy()

    def _saliency_frames(self, frames: torch.Tensor):
        """[n, segment_size] f32 on device -> (z [n, d] L2-normalized, dg
        [n, F, T] gradient of ||z||^2 / 2 at the mel input, g [n, F, T]
        the mel input).  Reference matcher.py:118-128: the forward runs
        with norm=False and the cotangent is z."""
        with torch.no_grad():
            g = self.mel(frames)
        with torch.enable_grad():
            g.requires_grad_(True)
            z = self.model(g, norm=False)
            (dg,) = torch.autograd.grad(z, g, grad_outputs=z.detach())
        z = z.detach()
        z = z / torch.clamp(torch.linalg.vector_norm(z, dim=1, keepdim=True), min=1e-12)
        return z, dg, g.detach()

    def embed_with_saliency(self, wav: np.ndarray):
        """Like :meth:`embed`, additionally returning the mel-input
        gradients and mel spectrograms ([S, F, T] each) for saliency
        rendering (index/saliency.py)."""
        S = wav.shape[0]
        F, T = self.model.F, self.model.T
        if S == 0:
            return (np.zeros((0, self.d), np.float32), np.zeros((0, F, T), np.float32),
                    np.zeros((0, F, T), np.float32))
        outs = [
            self._saliency_frames(torch.from_numpy(
                np.ascontiguousarray(wav[i : i + self.chunk], np.float32)
            ).to(self.device))
            for i in range(0, S, self.chunk)
        ]
        return tuple(torch.cat([o[j] for o in outs]).float().cpu().numpy()
                     for j in range(3))

    # ------------------------------------------------ packed-song path
    def can_pack(self, hop: int) -> bool:
        """The device unfold is a hop-reshape: it needs hop | segment."""
        return hop > 0 and self.segment_size % hop == 0

    @torch.inference_mode()
    def _songs_fn(self, buf: torch.Tensor, hop: int) -> torch.Tensor:
        """Packed-song program: [B, L] raw audio (int16 or f32) on device ->
        [B, T, d] embeddings.  /32768 for int16, hop-reshape unfold,
        per-segment de-mean, mel, model, L2 all run on the device."""
        B, L = buf.shape
        seg = self.segment_size
        k = seg // hop
        T = L // hop - (k - 1)
        x = buf.float() / 32768.0 if buf.dtype == torch.int16 else buf
        hops = x.reshape(B, L // hop, hop)
        frames = torch.cat([hops[:, i : i + T] for i in range(k)], dim=2)
        frames = frames - frames.mean(dim=2, keepdim=True)
        z = self.model(self.mel(frames.reshape(B * T, seg)), norm=True)
        return z.reshape(B, T, -1)

    def embed_songs_device(
        self, signals: list[np.ndarray], counts: list[int], hop: int,
    ):
        """Dispatch one packed batch of whole songs; returns a handle for
        :meth:`gather_songs` without waiting for the device.  signals: mono
        int16 (exact-scale) or float32; counts: complete windows per song."""
        if not self.can_pack(hop):
            raise ValueError("hop %d does not divide the segment" % hop)
        seg = self.segment_size
        need = max(
            (c - 1) * hop + seg if c > 0 else 0 for c in counts
        ) if counts else seg
        L = -(-max(need, seg) // seg) * seg  # whole segments
        all_i16 = all(s.dtype == np.int16 for s in signals)
        buf = np.zeros((len(signals), L), np.int16 if all_i16 else np.float32)
        for b, s in enumerate(signals):
            n = min(s.shape[0], L)
            if all_i16:
                buf[b, :n] = s[:n]
            elif s.dtype == np.int16:
                # a mixed batch rides the f32 carrier: rescale int16 here
                buf[b, :n] = s[:n].astype(np.float32) / 32768.0
            else:
                buf[b, :n] = np.asarray(s[:n], np.float32)
        return self._songs_fn(torch.from_numpy(buf).to(self.device), hop), list(counts)

    def gather_songs(self, handle) -> list[np.ndarray]:
        """Sync a dispatched packed batch -> per-song [n_i, d] float32."""
        dev, counts = handle
        z = dev.float().cpu().numpy()
        return [z[b, : counts[b]] for b in range(len(counts))]

    def embed_songs(
        self, signals: list[np.ndarray], counts: list[int], hop: int
    ) -> list[np.ndarray]:
        """Dispatch + gather, split into calls of at most chunk*4 windows
        (device memory scales with total windows, not with songs)."""
        if not signals:
            return []
        G = max(1, self.chunk * 4 // max(max(counts), 1))
        out: list[np.ndarray] = []
        for j in range(0, len(signals), G):
            out.extend(self.gather_songs(self.embed_songs_device(
                signals[j : j + G], counts[j : j + G], hop,
            )))
        return out

    def embed_stream(self, dataset, hop: int, num_workers: int = 4,
                     depth: int = 2, stats: dict | None = None):
        """Decode -> packed pipelined embed over a MusicDataset: yields
        (index, name, z [n, d] float32) in list order; errors yield a
        [0, d] array.  Up to ``depth`` dispatched batches stay in flight
        (CUDA runs them while the host decodes the next).  stats
        accumulates the decode_s/embed_s phase split."""
        if not self.can_pack(hop):
            raise ValueError("hop %d does not divide the segment" % hop)
        st = stats if stats is not None else {}
        st.setdefault("decode_s", 0.0)
        st.setdefault("embed_s", 0.0)
        inflight: collections.deque = collections.deque()
        pending: list[tuple[int, str, np.ndarray, int]] = []

        def dispatch():
            if not pending:
                return
            tm = time.time()
            handle = self.embed_songs_device(
                [p[2] for p in pending], [p[3] for p in pending], hop,
            )
            inflight.append((handle, list(pending)))
            pending.clear()
            st["embed_s"] += time.time() - tm

        def drain():
            handle, meta = inflight.popleft()
            tm = time.time()
            zs = self.gather_songs(handle)
            st["embed_s"] += time.time() - tm
            for (i, name, _, _), z in zip(meta, zs):
                yield i, name, z

        tm_decode = time.time()
        for i, name, sig, n_seg in dataset.iterate_raw(
            num_workers=num_workers,
            prefetch=max(4 * num_workers, (depth + 1) * max(self.chunk // 40, 1)),
        ):
            st["decode_s"] += time.time() - tm_decode
            if n_seg <= 0:
                # flush so the error row is yielded in list order
                dispatch()
                while inflight:
                    yield from drain()
                yield i, name, np.zeros((0, self.d), np.float32)
            else:
                pending.append((i, name, sig, int(n_seg)))
                if sum(p[3] for p in pending) >= self.chunk:
                    dispatch()
                while len(inflight) > depth:
                    yield from drain()
            tm_decode = time.time()
        dispatch()
        while inflight:
            yield from drain()
