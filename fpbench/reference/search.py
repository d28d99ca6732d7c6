"""Plain reference of the catalogue search: the exhaustive alignment score
of a query against every song at every offset, in float32 with TF32 off.

A query is S consecutive embedding rows.  Its score at (song s, offset t)
is the mean over its rows i of the inner product of row i with the song's
row t + i, a row off the song counting 0; offsets run over every t at
which the query overlaps the song.  The best alignment is the largest
score over all songs and offsets.  It imports nothing of the program.

``low=True`` is the control: the catalogue and the queries rounded to fp8
(e4m3) with one scale per tensor before the products, sums in f32.
"""

from __future__ import annotations

import torch

from fpbench.reference.fpnet import fp8_round


@torch.no_grad()
def best_alignment(db: torch.Tensor, q: torch.Tensor, *, low: bool = False,
                   song_block: int = 4096, query_block: int = 16):
    """db [n_songs, C, d] float32, q [K, S, d] float32, both on one device.
    Returns (score [K], song [K], t [K]) of each query's best alignment:
    the mean inner product, and the first song and offset reaching it."""
    if low:
        db, q = fp8_round(db), fp8_round(q)
    n, C, d = db.shape
    K, S, _ = q.shape
    score = torch.full((K,), -float("inf"), device=q.device)
    song = torch.zeros(K, dtype=torch.int64, device=q.device)
    t = torch.zeros(K, dtype=torch.int64, device=q.device)
    for k0 in range(0, K, query_block):
        qb = q[k0 : k0 + query_block]
        kb = qb.shape[0]
        qt = qb.reshape(kb * S, d).t()
        for s0 in range(0, n, song_block):
            rows = db[s0 : s0 + song_block]
            nb = rows.shape[0]
            p = (rows.reshape(nb * C, d) @ qt).reshape(nb, C, kb, S)
            p = torch.nn.functional.pad(p, (0, 0, 0, 0, S - 1, S - 1))
            # window sum at offset t = o - (S - 1): rows o .. o + S - 1 of the
            # padded product, query row i against row o + i
            align = p[:, 0 : C + S - 1, :, 0].clone()
            for i in range(1, S):
                align += p[:, i : i + C + S - 1, :, i]
            val, off = align.max(dim=1)  # [nb, kb], first offset reaching it
            bv, bs = val.max(dim=0)  # [kb], first song reaching it
            better = bv / S > score[k0 : k0 + kb]
            idx = torch.arange(kb, device=q.device)
            score[k0 : k0 + kb] = torch.where(better, bv / S, score[k0 : k0 + kb])
            song[k0 : k0 + kb] = torch.where(better, bs + s0, song[k0 : k0 + kb])
            t[k0 : k0 + kb] = torch.where(better, off[bs, idx] - (S - 1), t[k0 : k0 + kb])
    return score, song, t


@torch.no_grad()
def score_at(db: torch.Tensor, q: torch.Tensor, song: torch.Tensor,
             t: torch.Tensor) -> torch.Tensor:
    """The mean alignment score of each query q[k] [S, d] at (song[k], t[k]),
    rows off the song counting 0.  Returns [K] float32."""
    n, C, d = db.shape
    K, S, _ = q.shape
    rows = t[:, None] + torch.arange(S, device=q.device)[None, :]  # [K, S]
    on = (rows >= 0) & (rows < C) & (song[:, None] >= 0) & (song[:, None] < n)
    got = db[song.clamp(0, n - 1)[:, None], rows.clamp(0, C - 1)]  # [K, S, d]
    return ((got * q).sum(dim=2) * on).sum(dim=1) / S
