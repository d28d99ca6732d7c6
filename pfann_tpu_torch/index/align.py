"""Exhaustive-alignment retrieval engine (port of ``pfann_tpu/index/align.py``).

Every (song, offset) pair is scored,

    align[s, o, b] = sum_i db[s*R + o + i] . q_b[i],

over a uniform layout in which song s owns R = pad + max(counts) rows
(``pad`` leading zeros, the song, zero slack, and ``pad`` trailing zero
rows after the last song).  Window overhang at song boundaries scores
exactly zero, and offsets down to -pad are scored.  Recall is 1.0 by
construction.

``alignment_core`` is the engine's device step: on CUDA tensors it is the
hand-written align-reduce kernel (``index/align_kernel.py``), on CPU
tensors the plain PyTorch version.  One layout (``trailing_pad=True``)
serves both; the kernel reads rows >= N as zero, and takes any S up to
the layout pad and any batch size.  int8 layouts and queries (the
screened engine's coarse stage and int8 exact layout, ``index/screen.py``)
take the kernel's int32 path, as the JAX int8 branch does
(``pfann_tpu/index/align.py:175-182``).

``score_alpha != 0`` (exp(-alpha (1 - ip)^2) per window before the sum)
needs the per-window score slices, which the kernel never forms: on CPU
and CUDA alike it runs as torch ops (``align_kernel.window_reduce``: a
matmul to per-window scores, chunked over the batch by a byte cap, the
masked transform per window slice, the diagonal sum, the per-song max and
last-offset argmax), JAX's XLA alpha path (``pfann_tpu/index/align.py:
184-207``) in f32 sums of operands rounded to the layout dtype.  It
launches no align-reduce kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from pfann_tpu_torch.index.align_kernel import (
    align_reduce,
    window_reduce,
    zero_extended,
)
from pfann_tpu_torch.utils.profiling import span

DEFAULT_PAD = 32  # supports query windows up to 32 segments (> 10 s default)
MAX_BATCH = 1024  # filters per dispatch; bounds the [B, n_songs] outputs


def build_uniform_layout(
    embeddings: np.ndarray,
    counts: np.ndarray,
    pad: int = DEFAULT_PAD,
    trailing_pad: bool = True,
) -> tuple[np.ndarray, int]:
    """Re-pack the flat embedding matrix into uniform per-song regions of
    R = pad + max(counts) rows: [pad zeros | song rows | slack zeros],
    plus ``pad`` zero rows after the last song if ``trailing_pad``.
    Returns (db_padded, R).  (numpy copy of the JAX package's, without its
    TPU row and song-group rounding.)"""
    n_songs = len(counts)
    d = embeddings.shape[1] if embeddings.size else 0
    lmax = int(counts.max()) if n_songs else 0
    R = pad + lmax
    total = max(n_songs, 1) * R + (pad if trailing_pad else 0)
    db = np.zeros((total, d), dtype=np.float32)
    if embeddings.size:
        db[song_rows(counts, R, pad)] = embeddings
    return db, R


def song_rows(counts: np.ndarray, R: int, pad: int) -> np.ndarray:
    """Layout row of every embedding row, in order: row j of song s lands
    at s*R + pad + j (vectorized; a per-song loop is minutes at 100k
    songs)."""
    counts = np.asarray(counts, dtype=np.int64)
    song_of = np.repeat(np.arange(len(counts), dtype=np.int64), counts)
    start = np.pad(np.cumsum(counts), (1, 0))
    return song_of * R + pad + np.arange(counts.sum(), dtype=np.int64) - start[song_of]


def build_row_valid(
    counts: np.ndarray, R: int, pad: int, total: int
) -> np.ndarray:
    """f32 [total] marker of real song rows in a uniform layout (1.0 on
    rows holding embeddings, 0.0 on pad/slack)."""
    rv = np.zeros(total, dtype=np.float32)
    rv[song_rows(counts, R, pad)] = 1.0
    return rv


def _alpha_window(score_alpha, row_valid, q_valid, rows):
    """The alpha scoring as a per-window transform of the plain version:
    each window's inner product becomes exp(-alpha (1 - ip)^2), masked to 0
    off the song (row_valid [N]) and off the query (q_valid [S, B])."""
    rv = zero_extended(row_valid, rows)

    def window(i, ip, batch):
        l2 = 1.0 - ip
        c = torch.exp(-score_alpha * l2 * l2) * rv[i : ip.shape[0] + i, None]
        if q_valid is not None:
            c = c * q_valid[i, batch][None, :]
        return c

    return window


def alignment_core(
    db: torch.Tensor,
    queries: torch.Tensor,
    *,
    R: int,
    S: int,
    n_songs: int,
    score_alpha: float = 0.0,
    row_valid: torch.Tensor | None = None,
    q_valid: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """db [N, d] (rows >= N read as zero); queries [B, S, d] in db's dtype
    (f32, bf16, or int8 with int32 sums).

    Returns (song_best [B, n_songs] f32 — summed alignment score,
    song_argoff [B, n_songs] int32 — best window offset within the region,
    i.e. t + pad; ties go to the larger offset)."""
    if score_alpha != 0.0:
        check_device(db.device)
        if queries.device != db.device:
            raise ValueError("alignment_core: db on %s, queries on %s"
                             % (db.device, queries.device))
        window = _alpha_window(score_alpha, row_valid, q_valid, n_songs * R + S - 1)
        return window_reduce(db, queries, R, S, n_songs, window)
    return align_reduce(db, queries, R, S, n_songs)


def check_device(device: torch.device) -> None:
    """The engines run on a CUDA card or, when asked, on the CPU."""
    if device.type not in ("cuda", "cpu"):
        raise ValueError("unsupported device %s (cuda or cpu)" % device)


def _top1(best: torch.Tensor, argoff: torch.Tensor, pad: int):
    """best/argoff [B, n_songs] -> (song [B] int32, score_sum [B] f32,
    t [B] f32).  The first song reaching the max wins, as jnp.argmax."""
    song = torch.argmax(best, dim=1, keepdim=True)
    score = best.gather(1, song)[:, 0]
    t = (argoff.gather(1, song)[:, 0] - pad).float()
    return song[:, 0].int(), score, t


class AlignmentEngine:
    """Host wrapper: uniform padded layout + per-shift filter dispatch +
    time mapping.  One instance per loaded database, on one device."""

    def __init__(
        self,
        embeddings: np.ndarray,
        counts: np.ndarray,
        pad: int = DEFAULT_PAD,
        score_dtype: torch.dtype = torch.bfloat16,
        *,
        device: torch.device | str,
        score_alpha: float = 0.0,
    ):
        self.device = torch.device(device)
        check_device(self.device)
        self.score_alpha = float(score_alpha)
        db, R = build_uniform_layout(embeddings, counts, pad)
        self.pad = pad
        self.R = R
        self.n_songs = len(counts)
        self.d = db.shape[1]
        self.score_dtype = score_dtype
        self._db = torch.from_numpy(db).to(device=self.device, dtype=score_dtype)
        # filters per dispatch (the bench's --batch-sweep lowers it)
        self.max_batch = MAX_BATCH
        self._row_valid = None
        if self.score_alpha != 0.0:
            self._row_valid = torch.from_numpy(
                build_row_valid(counts, R, pad, db.shape[0])
            ).to(self.device)

    def max_query_windows(self) -> int:
        return self.pad  # longer filters would cross into the next region

    def _queries(self, chunk) -> torch.Tensor:
        """A chunk of filters as the kernel takes it: contiguous, in the
        layout dtype, on the engine's device.  A tensor already there in
        that dtype is used as it stands; a host array is uploaded."""
        if not isinstance(chunk, torch.Tensor):
            chunk = torch.from_numpy(np.ascontiguousarray(chunk, np.float32))
        return chunk.to(device=self.device, dtype=self.score_dtype).contiguous()

    def search_device(self, filters, sub_lens=None) -> list:
        """Dispatch alignment over ``max_batch``-row chunks without syncing;
        returns a list of (best, argoff) device tensors.  ``filters`` is a
        host array or a tensor (one on the engine's device is not copied).
        sub_lens [B] (optional) masks zero filter rows on the alpha path
        only."""
        return self._dispatch(filters, sub_lens, top1=False)

    def search_top1_device(self, filters) -> list:
        """Serving fast path: per query only (song, score_sum, t) leave the
        device.  Returns a list of device-tensor triples per chunk."""
        return self._dispatch(filters, None, top1=True)

    def _dispatch(self, filters, sub_lens, top1: bool) -> list:
        B, S, _ = filters.shape
        mb = self.max_batch
        outs = []
        for i in range(0, B, mb):
            chunk = filters[i : i + mb]
            n = chunk.shape[0]
            q_valid = None
            with span("align.upload"):
                if self.score_alpha != 0.0:
                    lens = (np.full(n, S, np.int32) if sub_lens is None
                            else np.asarray(sub_lens[i : i + n]))
                    q_valid = torch.from_numpy(
                        (np.arange(S)[:, None] < lens[None, :]).astype(np.float32)
                    ).to(self.device)
                q = self._queries(chunk)
            with span("align.scan"):
                best, argoff = alignment_core(
                    self._db, q, R=self.R, S=S, n_songs=self.n_songs,
                    score_alpha=self.score_alpha, row_valid=self._row_valid,
                    q_valid=q_valid,
                )
                outs.append(_top1(best, argoff, self.pad) if top1 else (best, argoff))
        return outs

    def search_top1(self, qpad):
        """Synced top-1 answers (host arrays): (song [B] int32, score_sum
        [B] f32, t [B] f32 in DB-hop units from song start)."""
        outs = self.search_top1_device(qpad)
        with span("align.fetch"):
            song = np.concatenate([o[0].cpu().numpy() for o in outs])
            best = np.concatenate([o[1].cpu().numpy() for o in outs]).astype(np.float32)
            t = np.concatenate([o[2].cpu().numpy() for o in outs])
        return song, best, t

    def search(
        self, filters: np.ndarray, sub_lens: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        """filters [B, S, d] (zero rows beyond sub_lens[b]); returns
        (song_score [B, n_songs] — mean alignment, song_t [B, n_songs] —
        offset in DB-hop units relative to song start)."""
        outs = self.search_device(filters, sub_lens)
        song_best = np.concatenate([b.cpu().numpy() for b, _ in outs])
        song_off = np.concatenate([o.cpu().numpy() for _, o in outs])
        song_score = (song_best / np.maximum(sub_lens, 1)[:, None]).astype(np.float32)
        song_t = (song_off - self.pad).astype(np.float32)
        return song_score, song_t


def queries_to_filters(
    query: np.ndarray, frame_shift_mul: int, max_windows: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Split one query [S_rows, d] (rows at hop/frame_shift_mul stride)
    into per-shift filters.  Returns (filters [fsm, S_max, d], sub_lens
    [fsm], shifts [fsm])."""
    fsm = frame_shift_mul
    subs = [query[s::fsm] for s in range(fsm)]
    S_max = min(max(len(s) for s in subs), max_windows)
    filters = np.zeros((fsm, S_max, query.shape[1]), dtype=np.float32)
    sub_lens = np.zeros(fsm, dtype=np.int32)
    for s, sub in enumerate(subs):
        n = min(len(sub), S_max)
        filters[s, :n] = sub[:n]
        sub_lens[s] = n
    return filters, sub_lens, np.arange(fsm)
