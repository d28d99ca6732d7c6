"""The topk engine: MIPS top-k, then a sequence-alignment rerank (port of
``pfann_tpu/index/search.py``), plus the host-side helpers the other
engines share (``bucket_windows``, ``finalize_song_scores``).

The reference searches each query row's top-k DB rows (faiss, here an
exact matmul plus top-k), turns every hit into a candidate (song, offset)
and scores each candidate by its mean window inner product (seqscore.cpp).
The JAX package runs all of it in XLA, so this is plain torch ops:

  * ``mips_topk``: scores in f32 from operands rounded to the DB dtype
    (JAX multiplies bf16 operands into f32, ``preferred_element_type``);
    the top-k lists equal values lower index first, as ``jax.lax.top_k``
    does (``torch.topk`` promises no order on ties, so ``_topk_lower_first``
    repairs it).  The JAX package's ``backend`` knob picks
    ``jax.lax.approx_max_k`` on a TPU; here every backend is the exact
    top-k, whose recall is at least the approximate one's (and JAX's
    ``approx_max_k`` is exact off the TPU).
  * ``seq_rerank``: every (row, hit) pair is a candidate, without dedup
    (a duplicate recomputes the same score and cannot change a max).  A
    candidate's window inner products are read out of the [S, N] score
    table of the f32 queries (the same dots JAX's gathered einsum sums),
    so the rerank gathers S*k*J scalars instead of S*k*J rows of d.
  * the per-song max is a ``scatter_reduce("amax")`` into a -inf table;
    the per-song argmax is a second one over the candidate indices at the
    max, so the LARGEST such candidate wins, as JAX's second segment max.
    A song with no candidate keeps -inf and time 0.

``TopkEngine`` holds the DB on the device and answers query batches in
chunks whose transients stay under ``SCORE_BYTES_CAP``; a query's answer
does not depend on the queries batched with it.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def bucket_windows(s: int, cap: int) -> int:
    """Round the filter window count up to a multiple of 8 (capped at the
    layout pad) — zero filter rows score zero, so padding S is free."""
    return min(-(-s // 8) * 8, max(cap, s))


def finalize_song_scores(
    song_max: np.ndarray, song_time: np.ndarray, hop_size: float, frame_shift_mul: int
) -> tuple[float, tuple[int, float], np.ndarray]:
    """Reference result contract: (best_score, (best_song, best_time_s),
    song_score [n_songs, 2]); the table keeps the 0-floor and times are in
    seconds."""
    scale = hop_size / frame_shift_mul
    song_score = np.zeros([song_max.shape[0], 2], dtype=np.float32)
    pos = song_max > 0
    song_score[pos, 0] = song_max[pos]
    song_score[pos, 1] = song_time[pos] * scale
    if song_max.size == 0 or not np.isfinite(song_max).any():
        return -float("inf"), (-1, 0.0), song_score
    best_song = int(np.argmax(song_max))
    best = float(song_max[best_song])
    best_time = float(song_time[best_song] * scale)
    return best, (best_song, best_time), song_score


def _topk_lower_first(scores: torch.Tensor, k: int):
    """``jax.lax.top_k`` of scores [R, N] along the last axis: the k
    largest, descending, equal values lower index first.  torch.topk gives
    the right values; the order among equal values is then made ascending
    by index, and a row whose k-th value also sits outside the top-k takes
    its lowest-indexed copies of it."""
    vals, idx = torch.topk(scores, k, dim=-1)
    idx, perm = idx.sort(dim=-1)
    vals, perm = vals.gather(-1, perm).sort(dim=-1, descending=True, stable=True)
    idx = idx.gather(-1, perm)
    if k:
        kth = vals[:, -1:]
        short = ((scores == kth).sum(-1) > (vals == kth).sum(-1)).nonzero()[:, 0]
        for r in short.tolist():
            above = idx[r][vals[r] > kth[r]]
            ties = (scores[r] == kth[r]).nonzero()[: k - len(above), 0]
            idx[r] = torch.cat([above, ties])
            vals[r] = scores[r, idx[r]]
    return vals, idx


def mips_topk(db: torch.Tensor, queries: torch.Tensor, k: int):
    """Maximum-inner-product top-k.  db [N, d] (f32, or bf16 values);
    queries [R, d] f32 (rounded to db's dtype first).  Returns (scores
    [R, k] f32, labels [R, k] int32), k capped at N."""
    scores = queries.to(db.dtype).float() @ db.float().T
    vals, idx = _topk_lower_first(scores, min(k, db.shape[0]))
    return vals, idx.int()


def _rerank(table, song_pos, labels, valid, n_songs, fsm, score_alpha):
    """seq_rerank on a batch.  table [n, S, N] f32: query row x DB row
    inner products; labels [n, S, k] (-1 = no hit); valid [n, S] bool.
    Returns (song_max [n, n_songs] f32, song_time [n, n_songs] f32)."""
    n, S, k = labels.shape
    N = table.shape[-1]
    dev = labels.device
    C, J = S * k, -(-S // fsm)
    flat_row = torch.arange(S, device=dev).repeat_interleave(k)  # [C]
    cand_shift = flat_row % fsm
    lab = labels.reshape(n, C).long()
    lab_ok = (lab >= 0) & valid[:, flat_row]
    safe_lab = torch.where(lab_ok, lab, 0)
    cand_song = torch.searchsorted(song_pos, safe_lab, right=True) - 1
    start = song_pos[cand_song]
    song_len = song_pos[cand_song + 1] - start
    cand_t = safe_lab - start - flat_row // fsm  # [n, C]

    # window row j of candidate c: DB row start + t + j against query row
    # j*fsm + shift; rows off the query or off the song add 0
    j = torch.arange(J, device=dev)
    qrow = j * fsm + cand_shift[:, None]  # [C, J]
    qclip = qrow.clamp(max=S - 1)
    pos = cand_t[..., None] + j  # [n, C, J]
    w_ok = ((qrow < S) & valid[:, qclip]) & (pos >= 0) & (pos < song_len[..., None])
    db_row = (start[..., None] + pos).clamp(0, N - 1)
    b = torch.arange(n, device=dev)[:, None, None]
    ip = table.reshape(-1)[(b * S + qclip) * N + db_row]
    if score_alpha > 0.0:
        l2 = 1.0 - ip
        ip = torch.exp(-score_alpha * l2 * l2)
    contrib = torch.where(w_ok, ip, 0.0)
    # per-shift subquery length, from the true (valid) query length
    s_true = valid.sum(1, keepdim=True)
    my_len = torch.div(s_true - cand_shift + fsm - 1, fsm, rounding_mode="floor")
    sco = contrib.sum(-1) / my_len.clamp(min=1).float()
    sco = torch.where(lab_ok, sco, -torch.inf)

    # per-song max, then the largest candidate index reaching it
    seg = torch.where(lab_ok, cand_song, n_songs) + b[:, :, 0] * (n_songs + 1)
    song_max = torch.full((n * (n_songs + 1),), -torch.inf, device=dev).scatter_reduce(
        0, seg.reshape(-1), sco.reshape(-1), "amax", include_self=False)
    is_best = lab_ok & (sco == song_max[seg])
    cand_idx = torch.arange(C, device=dev).expand(n, C)
    best_idx = torch.full((n * (n_songs + 1),), -1, dtype=torch.long, device=dev)
    best_idx = best_idx.scatter_reduce(0, seg.reshape(-1),
                                       torch.where(is_best, cand_idx, -1).reshape(-1),
                                       "amax", include_self=False)
    best_idx = best_idx.view(n, n_songs + 1)[:, :n_songs]
    cand_time = (cand_t * fsm - cand_shift).float()
    song_time = torch.where(best_idx >= 0, cand_time.gather(1, best_idx.clamp(min=0)), 0.0)
    return song_max.view(n, n_songs + 1)[:, :n_songs], song_time


def seq_rerank(db, song_pos, queries, labels, valid_rows, n_songs,
               frame_shift_mul=1, score_alpha=0.0):
    """Sequence-alignment rerank over top-k hits (``seq_rerank`` of the
    JAX package).  db [N, d]; song_pos [n_songs + 1] cumulative offsets;
    queries [S, d] f32 (zero rows past the true length); labels [S, k]
    (-1 = no hit); valid_rows [S] bool.  Returns (song_max [n_songs] f32,
    not 0-floored; song_time [n_songs] f32 in sub-hop units, t*fsm -
    shift, at that max)."""
    table = (queries.float() @ db.float().T)[None]
    song_max, song_time = _rerank(table, song_pos.long(), labels[None],
                                  valid_rows[None], n_songs, frame_shift_mul,
                                  score_alpha)
    return song_max[0], song_time[0]


def search_and_rerank(db, song_pos, queries, valid_rows, *, top_k, n_songs,
                      frame_shift_mul=1, score_alpha=0.0):
    """One query: MIPS top-k per valid row, then the rerank.  Returns
    (song_max [n_songs], song_time [n_songs]), see ``seq_rerank``."""
    _, labels = mips_topk(db, queries, top_k)
    labels = torch.where(valid_rows[:, None], labels, -1)
    return seq_rerank(db, song_pos, queries, labels, valid_rows, n_songs,
                      frame_shift_mul=frame_shift_mul, score_alpha=score_alpha)


class TopkEngine:
    """The topk engine on one device: the flat embedding matrix in
    ``score_dtype`` and the song offsets.

    ``search`` is the batched form of ``search_and_rerank`` (the JAX
    package vmaps it): queries are zero-padded to the longest of a chunk,
    and a chunk holds as many queries as keep its score table and rerank
    gathers under SCORE_BYTES_CAP."""

    SCORE_BYTES_CAP = 4 << 30

    def __init__(self, embeddings: np.ndarray, song_pos: np.ndarray, *,
                 top_k: int, frame_shift_mul: int = 1, score_alpha: float = 0.0,
                 score_dtype: torch.dtype = torch.bfloat16,
                 device: torch.device | str):
        self.device = torch.device(device)
        self.top_k = int(top_k)
        self.fsm = int(frame_shift_mul)
        self.score_alpha = float(score_alpha)
        self.n_songs = len(song_pos) - 1
        self.d = embeddings.shape[1]
        self._db = torch.from_numpy(embeddings).to(self.device).to(score_dtype)
        self._song_pos = torch.from_numpy(np.asarray(song_pos, np.int64)).to(self.device)

    def _chunk_for(self, S: int) -> int:
        """Queries per dispatch: per query an [S, N] f32 score table (the
        top-k one is freed before the rerank one is made) and the rerank's
        [S*k, J] gathers (indices, masks, scores: ~64 bytes each)."""
        N, k = self._db.shape[0], min(self.top_k, self._db.shape[0])
        per_q = 4 * S * N + 64 * S * k * -(-S // self.fsm)
        return max(1, self.SCORE_BYTES_CAP // max(per_q, 1))

    def search(self, queries: Sequence[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
        """queries: [S_i, d] f32 arrays (rows at hop/fsm stride).  Returns
        (song_max [B, n_songs], song_time [B, n_songs] in sub-hop units)."""
        B = len(queries)
        S = max(max(q.shape[0] for q in queries), 1)
        chunk = self._chunk_for(S)
        song_max = np.empty((B, self.n_songs), np.float32)
        song_time = np.empty((B, self.n_songs), np.float32)
        for b0 in range(0, B, chunk):
            part = queries[b0 : b0 + chunk]
            n, Sc = len(part), max(max(q.shape[0] for q in part), 1)
            qpad = np.zeros((n, Sc, self.d), np.float32)
            valid = np.zeros((n, Sc), bool)
            for i, q in enumerate(part):
                qpad[i, : q.shape[0]] = q
                valid[i, : q.shape[0]] = True
            q = torch.from_numpy(qpad).to(self.device)
            valid_t = torch.from_numpy(valid).to(self.device)
            _, labels = mips_topk(self._db, q.reshape(n * Sc, self.d), self.top_k)
            labels = torch.where(valid_t.reshape(-1, 1), labels, -1).view(n, Sc, -1)
            table = q @ self._db.float().T  # [n, Sc, N], of the f32 queries
            sm, st = _rerank(table, self._song_pos, labels, valid_t, self.n_songs,
                             self.fsm, self.score_alpha)
            del table
            song_max[b0 : b0 + n] = sm.cpu().numpy()
            song_time[b0 : b0 + n] = st.cpu().numpy()
        return song_max, song_time
