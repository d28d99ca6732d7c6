"""Host-side helpers of ``pfann_tpu/index/search.py`` (numpy copies):
``bucket_windows`` fixes the filter width the engine is given, and
``finalize_song_scores`` is the reference result contract."""

from __future__ import annotations

import numpy as np


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
