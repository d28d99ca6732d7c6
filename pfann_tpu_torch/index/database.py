"""Fingerprint database: DB directory + device-resident exhaustive engine
(port of ``pfann_tpu/index/database.py``).

The DB directory is the JAX package's, byte for byte:

    <db>/embeddings       raw float32 [N, d]
    <db>/landmarkKey      int32 per-song segment counts
    <db>/songList.txt     one path per line
    <db>/configs.json     the config snapshot
    <db>/model.msgpack    flax-format params (utils/checkpoint.py reads it)
    <db>/index_meta.json  search settings (d, ntotal, align_pad)

Engines: the exhaustive alignment engine (``engine="align"``), the
screened engine (``engine="screen"``, ``screen: true``, or ``screen:
"auto"`` at 30,000 songs or more, as in the JAX package), which honours the
indexer keys ``screen_pool_k``, ``screen_top_m``, ``screen_coarse_dtype``,
``screen_exact_dtype``, ``screen_rescue`` (default 0.4; 0/false disables)
and ``backend``, and the topk engine (``engine="topk"``: top-k per query
row, then the sequence rerank, ``index/search.py``).  A query with more
windows than the fast engines' layout pad is served by the topk engine,
with one warning per length, as in the JAX package.  The sharded engine
raises NotImplementedError (ROADMAP: multi-GPU).
"""

from __future__ import annotations

import json
import os
from typing import Any, Sequence

import numpy as np
import torch

from pfann_tpu_torch.index.align import (
    DEFAULT_PAD,
    AlignmentEngine,
    queries_to_filters,
)
from pfann_tpu_torch.index.screen import ScreenedAlignmentEngine
from pfann_tpu_torch.index.search import (
    TopkEngine,
    bucket_windows,
    finalize_song_scores,
)
from pfann_tpu_torch.utils.config import read_file_list
from pfann_tpu_torch.utils.logging import get_logger

INDEX_META_NAME = "index_meta.json"
MODEL_FILE_NAME = "model.msgpack"


def write_index_meta(dir_for_db: str, d: int, meta: dict[str, Any] | None = None):
    out = {"version": 1, "metric": "inner_product", "d": d}
    if meta:
        out.update(meta)
    with open(os.path.join(dir_for_db, INDEX_META_NAME), "w") as f:
        json.dump(out, f, indent=2)


class Database:
    """Loads a DB directory and answers queries on ``device``."""

    def __init__(
        self,
        dir_for_db: str,
        indexer_params: dict[str, Any],
        hop_size: float,
        device: torch.device | str,
    ):
        self.dir_for_db = dir_for_db
        self.params = indexer_params
        self.frame_shift_mul = int(self.params.get("frame_shift_mul", 1))
        self.score_alpha = float(self.params.get("score_alpha", 0))
        self.hop_size = hop_size
        logger = get_logger()

        self.songList = read_file_list(os.path.join(dir_for_db, "songList.txt"))
        counts = np.fromfile(os.path.join(dir_for_db, "landmarkKey"), dtype=np.int32)
        if len(self.songList) != counts.shape[0]:
            raise ValueError("songList.txt and landmarkKey disagree on the song count")
        self.top_k = int(self.params["top_k"])
        self.song_pos = np.pad(np.cumsum(counts, dtype=np.int64), (1, 0))

        meta_path = os.path.join(dir_for_db, INDEX_META_NAME)
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            d = int(meta["d"])
        else:
            meta = {}
            d = int(self.params.get("d", 128))
        self.meta = meta
        emb = np.fromfile(
            os.path.join(dir_for_db, "embeddings"), dtype=np.float32
        ).reshape([-1, d])
        if emb.shape[0] != self.song_pos[-1]:
            raise ValueError("embeddings hold %d rows, landmarkKey counts %d"
                             % (emb.shape[0], self.song_pos[-1]))
        self.d = d
        self.ntotal = emb.shape[0]

        engine = self.params.get("engine", "align")
        # screen: true | false | 'auto' (default): auto upgrades the
        # exhaustive engine to the screened one at 30,000 songs, the JAX
        # package's threshold (pfann_tpu/index/database.py:129-143)
        screen = self.params.get("screen", "auto")
        if engine == "align" and (
            screen is True or (screen == "auto" and len(counts) >= 30_000)
        ):
            engine = "screen"
        if engine not in ("align", "screen", "topk"):
            raise ValueError("unknown engine %r (align, screen or topk)" % (engine,))
        if self.params.get("sharded", False):
            raise NotImplementedError(
                "sharded search is not ported (ROADMAP: multi-GPU)"
            )
        self.engine = engine
        # align_pad: explicit indexer knob > index_meta (builder's
        # max_query_sec) > engine default
        self.align_pad = (
            int(self.params.get("align_pad", 0))
            or int(meta.get("align_pad", 0))
            or None
        )
        dtype = (torch.bfloat16 if self.params.get("db_dtype", "bfloat16")
                 == "bfloat16" else torch.float32)
        self._device, self._dtype, self._emb_host = device, dtype, emb
        self._topk = None  # built at first use (the fast engines' fallback)
        self._fallback_logged: set = set()
        if engine == "topk":
            if self.params.get("backend", "auto") == "approx":
                logger.info("topk backend 'approx' (approx_max_k, a TPU op): "
                            "this engine takes the exact top-k")
            self._topk_engine()
        elif engine == "align":
            self._align = AlignmentEngine(
                emb, counts, score_dtype=dtype, device=device,
                pad=self.align_pad or DEFAULT_PAD, score_alpha=self.score_alpha,
            )
        else:
            self._align = ScreenedAlignmentEngine(
                emb, counts, score_dtype=dtype, device=device,
                pad=self.align_pad or DEFAULT_PAD,
                k=int(self.params.get("screen_pool_k", 4)),
                top_m=int(self.params.get("screen_top_m", 32)),
                coarse_dtype=self.params.get("screen_coarse_dtype"),
                exact_dtype=self.params.get("screen_exact_dtype"),
                backend=self.params.get("backend", "auto"),
                score_alpha=self.score_alpha,
                rescue_threshold=float(
                    self.params.get("screen_rescue", 0.4) or 0.0
                ) or None,
            )
        logger.info("score alpha: %d", self.score_alpha)

    def _topk_engine(self) -> TopkEngine:
        """The flat-matrix topk engine, uploaded at first use."""
        if self._topk is None:
            self._topk = TopkEngine(
                self._emb_host, self.song_pos, top_k=self.top_k,
                frame_shift_mul=self.frame_shift_mul, score_alpha=self.score_alpha,
                score_dtype=self._dtype, device=self._device,
            )
        return self._topk

    def _use_align(self, n_rows: int) -> bool:
        """Whether a query of n_rows rows fits the fast engine's layout pad;
        a longer one is served by the topk engine, logged once per length."""
        if self.engine == "topk":
            return False
        sub_len = -(-n_rows // self.frame_shift_mul)
        max_windows = self._align.max_query_windows()
        if sub_len <= max_windows:
            return True
        if sub_len not in self._fallback_logged:
            self._fallback_logged.add(sub_len)
            get_logger().warning(
                "query with %d windows exceeds the %s engine's %d-window layout "
                "pad; serving via the topk fallback engine (build/load with "
                "indexer align_pad >= %d to keep it on the fast path)",
                sub_len, self.engine, max_windows, sub_len,
            )
        return False

    def _filters(self, queries):
        """Per-shift filters of every query, zero-padded to one bucketed
        width: (filters [B*fsm, S, d], sub_lens [B*fsm])."""
        fsm = self.frame_shift_mul
        max_w = self._align.max_query_windows()
        filters, sub_lens = [], []
        for q in queries:
            f, sl, _ = queries_to_filters(q, fsm, max_w)
            filters.append(f)
            sub_lens.append(sl)
        S_max = bucket_windows(max(f.shape[1] for f in filters), max_w)
        allf = np.zeros((len(queries) * fsm, S_max, self.d), np.float32)
        for i, f in enumerate(filters):
            allf[i * fsm : (i + 1) * fsm, : f.shape[1]] = f
        return allf, np.concatenate(sub_lens)

    # ------------------------------------------------------------------
    def query_embeddings(
        self, query: np.ndarray
    ) -> tuple[float, tuple[int, float], np.ndarray]:
        """One query [S, d] float32 -> (best_score, (song_id, time_s),
        song_score [n_songs, 2])."""
        if self.ntotal == 0 or query.shape[0] == 0:
            return -float("inf"), (-1, 0.0), np.zeros(
                [len(self.songList), 2], dtype=np.float32
            )
        return self.query_embeddings_batch([query])[0]

    def _query_align_batch(self, queries):
        """(song_max [B, n_songs], song_time_subhop [B, n_songs]) with the
        fsm shifted variants merged (t * fsm - shift time convention)."""
        fsm = self.frame_shift_mul
        allf, sub_lens = self._filters(queries)
        score, t = self._align.search(allf, sub_lens)
        score = score.reshape(len(queries), fsm, -1)
        t = t.reshape(len(queries), fsm, -1)
        t_subhop = t * fsm - np.arange(fsm)[None, :, None]
        # every per-song best is floored at exactly 0 (offsets wholly in
        # the pad score 0), so the plain argmax over shifts is safe
        best_shift = np.argmax(score, axis=1)
        gi = np.indices(best_shift.shape)
        return (
            score[gi[0], best_shift, gi[1]],
            t_subhop[gi[0], best_shift, gi[1]].astype(np.float32),
        )

    def query_embeddings_batch(
        self, queries: Sequence[np.ndarray]
    ) -> list[tuple[float, tuple[int, float], np.ndarray]]:
        """Many queries scored in one engine call (full per-song tables)."""
        if not queries:
            return []
        if self._use_align(max(q.shape[0] for q in queries)):
            song_max, song_time = self._query_align_batch(queries)
        else:
            song_max, song_time = self._topk_engine().search(queries)
        return [
            finalize_song_scores(
                song_max[i], song_time[i], self.hop_size, self.frame_shift_mul
            )
            for i in range(len(queries))
        ]

    def query_top1_batch(
        self, queries: Sequence[np.ndarray]
    ) -> list[tuple[float, tuple[int, float]]]:
        """Serving fast path: the best (score, (song_id, time_s)) per query;
        only [B]-sized answers leave the device.  score_alpha, the topk
        engine and queries longer than the layout pad take the full-table
        path, as in the JAX package."""
        if not queries:
            return []
        if self.ntotal == 0:
            return [(-float("inf"), (-1, 0.0))] * len(queries)
        if (self.score_alpha != 0.0
                or not self._use_align(max(q.shape[0] for q in queries))):
            return [r[:2] for r in self.query_embeddings_batch(queries)]
        fsm = self.frame_shift_mul
        B = len(queries)
        scale = self.hop_size / fsm
        allf, lens = self._filters(queries)
        if self.engine == "screen":
            # the rescue gate divides the score sums by the true lengths
            song, ssum, t = self._align.search_top1(allf, lens)
        else:
            song, ssum, t = self._align.search_top1(allf)
        mean = (ssum / np.maximum(lens, 1)).reshape(B, fsm)
        song = song.reshape(B, fsm)
        t_sub = t.reshape(B, fsm) * fsm - np.arange(fsm)[None, :]
        pick = np.argmax(mean, axis=1)
        return [
            (
                float(mean[i, pick[i]]),
                (int(song[i, pick[i]]), float(t_sub[i, pick[i]] * scale)),
            )
            for i in range(B)
        ]
