"""Song-sharded retrieval over several devices (port of
``pfann_tpu/parallel/sharded_search.py``).

The song set is partitioned into shards balanced by segment count; each
shard's layout lives on its own device, and every query batch runs on
every shard.  Only per-shard results that are already reduced cross to the
lead device (``devices[0]``): per-song tables for ``query_batch``, one
(score, slot, offset) triple per query and shard for the top-1 paths.

Engines, as in the JAX package:

  * ``align``: each shard holds a uniform layout of its songs at the
    GLOBAL region length R = pad + max(counts), rounded up to 8, with
    songs_max regions (the largest shard's song count); the align-reduce
    kernel runs once per shard (the plain version on CPU tensors).
  * ``screen``: each shard holds the screened engine's layout and pooled
    copy at the global geometry (``screen_geometry`` of the global longest
    song and the largest shard), the int8 copies under one scale; stages
    1+2 run per shard (``index/screen.screen_core``, top_m capped at the
    shard's slots), and the stage-3 rescue gate is GLOBAL: it is taken on
    the merged answer, and an escalated query is rescored on every shard
    (``index/screen.rescue_tables``) and merged again.  Per-shard rescue
    gates would differ wherever one shard's best is below the cut and the
    global best is not.
  * ``topk``: per-shard MIPS top-k and sequence rerank (the port's
    ``TopkEngine``); each shard takes its own top-k, so the candidates are
    a superset of the unsharded engine's.

Top-1 merge and tie rule (JAX's argmax over the shard-major flat index
``shard * songs_max + slot``): the first maximum wins, the lower shard
first, then the lower slot (for the screen: the earlier survivor in its
stage-1 order).  ``flat_to_song`` maps flat indices through ``song_map``
(-1 marks padding slots).  ``score_alpha`` runs on the align and screen
engines through the torch-op alpha path, launching no kernel, as
unsharded.

Dropped, being TPU-only: ``mesh``/``axis`` (here ``devices``),
``impl``/``interpret``, the S and B buckets and the fused ``lax.cond``
rescue (the kernel takes any S and B; the gate costs one host sync per
dispatch chunk, the answers are the same).
"""

from __future__ import annotations

import contextlib
import types

import numpy as np
import torch

from pfann_tpu_torch.index.align import (
    MAX_BATCH,
    alignment_core,
    build_row_valid,
    check_device,
    song_rows,
)
from pfann_tpu_torch.index.screen import (
    ScreenedAlignmentEngine,
    build_screen_layout,
    coarse_dtype_of,
    quantize_coarse_int8,
    rescue_tables,
    screen_core,
    screen_geometry,
    stage2_chunk,
)
from pfann_tpu_torch.index.search import TopkEngine
from pfann_tpu_torch.utils.logging import get_logger


def partition_songs(counts: np.ndarray, n_shards: int) -> list[list[int]]:
    """Greedy balanced partition of songs into n_shards by segment count,
    preserving song order inside a shard (a copy of the JAX package's)."""
    order = np.argsort(-counts, kind="stable")
    loads = np.zeros(n_shards, dtype=np.int64)
    groups: list[list[int]] = [[] for _ in range(n_shards)]
    for song in order:
        s = int(np.argmin(loads))
        groups[s].append(int(song))
        loads[s] += int(counts[song])
    return [sorted(g) for g in groups]


def gather_shard_rows(
    embeddings: np.ndarray, song_pos: np.ndarray, counts: np.ndarray,
    ga, d: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized ragged gather of one shard's songs' embedding rows:
    returns (rows [counts[ga].sum(), d], counts[ga]) (a copy of the JAX
    package's)."""
    ga = np.asarray(ga, dtype=np.int64)
    if not len(ga):
        return np.zeros((0, d), np.float32), np.zeros(0, np.int64)
    loc_counts = np.asarray(counts, dtype=np.int64)[ga]
    starts = song_pos[ga]
    ends = np.cumsum(loc_counts)
    idx = (
        np.repeat(starts, loc_counts)
        + np.arange(int(ends[-1]), dtype=np.int64)
        - np.repeat(ends - loc_counts, loc_counts)
    )
    return embeddings[idx], loc_counts


def _on(device: torch.device):
    """Run the ops inside on ``device``'s card (nothing to do on the CPU)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _upload(arr: np.ndarray, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """Host array -> tensor of ``dtype`` on ``device``, cast there."""
    return torch.from_numpy(arr).to(device).to(dtype)


class ShardedDatabase:
    """A song-sharded database over ``devices`` (one shard each; a device
    may repeat).  Host-side construction re-packs the flat embedding file
    into per-shard layouts of one common geometry; ``song_map``
    [n_shards, songs_max] holds each slot's global song id (-1 = padding).
    """

    def __init__(
        self,
        embeddings: np.ndarray,
        counts: np.ndarray,
        devices,
        *,
        engine: str = "topk",
        top_k: int = 100,
        frame_shift_mul: int = 1,
        score_alpha: float = 0.0,
        backend: str = "exact",
        db_dtype: torch.dtype = torch.bfloat16,
        align_pad: int = 32,
        screen_k: int = 4,
        screen_top_m: int = 32,
        screen_coarse_dtype=None,
        screen_rescue: float | None = None,
    ):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("ShardedDatabase needs at least one device")
        for dev in self.devices:
            check_device(dev)
        if engine not in ("topk", "align", "screen"):
            raise ValueError("unknown engine %r (topk, align or screen)" % (engine,))
        if backend not in ("auto", "exact", "approx"):
            raise ValueError("unknown backend %r" % (backend,))
        if backend == "approx":
            get_logger().info("backend 'approx' (approx_max_k, a TPU op): the "
                              "sharded engines take the exact top-k")
        self.backend = "exact"
        self.engine = engine
        self.pad = align_pad
        self.top_k = top_k
        self.frame_shift_mul = frame_shift_mul
        self.score_alpha = float(score_alpha)
        self.db_dtype = db_dtype
        # the screen's stage-3 cut in mean-IP units; with score_alpha mapped
        # through the per-window transform (an approximation, as in JAX)
        self.rescue_tau = None
        if engine == "screen" and screen_rescue:
            t = float(screen_rescue)
            self.rescue_tau = (float(np.exp(-self.score_alpha * (1.0 - t) ** 2))
                               if self.score_alpha != 0.0 else t)
        self.n_shards = len(self.devices)
        self.n_songs = len(counts)
        self.d = embeddings.shape[1] if embeddings.size else 128
        counts = np.asarray(counts, dtype=np.int64)
        song_pos = np.pad(np.cumsum(counts), (1, 0))
        groups = partition_songs(counts, self.n_shards)
        self.songs_max = max((len(g) for g in groups), default=0)
        self.lmax = int(counts.max()) if len(counts) else 0
        self.shards = [types.SimpleNamespace(device=dev) for dev in self.devices]
        # one shard's rows at a time (a copy of the corpus at 100k songs)
        shard_rows = (gather_shard_rows(embeddings, song_pos, counts, g, self.d)
                      for g in groups)
        if engine == "screen":
            self._build_screen(shard_rows, groups, screen_k, screen_top_m,
                               screen_coarse_dtype)
        elif engine == "align":
            self._build_align(shard_rows)
        else:
            self._build_topk(shard_rows, groups, counts)
        self.song_map = np.full((self.n_shards, self.songs_max), -1, dtype=np.int32)
        for si, g in enumerate(groups):
            self.song_map[si, : len(g)] = g

    # ------------------------------------------------------------ builds
    def _build_screen(self, shard_rows, groups, k, top_m, coarse_dtype) -> None:
        pad, alpha = self.pad, self.score_alpha
        self.screen_k = k
        # the GLOBAL geometry on every shard: the longest song, the largest shard
        self.R, n_pad = screen_geometry(self.lmax, self.songs_max, pad, k)
        self.Rc = self.R // k
        self.songs_max = n_pad
        self.top_m = min(top_m, n_pad)
        cdt = coarse_dtype_of(coarse_dtype, self.db_dtype)
        coarse_host = []
        for sh, g, (loc_emb, loc_counts) in zip(self.shards, groups, shard_rows):
            db3, coarse, _, _, _ = build_screen_layout(
                loc_emb, loc_counts, pad=pad, k=k, d=self.d, R=self.R, n_pad=n_pad)
            sh.db3 = _upload(db3, self.db_dtype, sh.device)
            del db3
            coarse_host.append(coarse)
            sh.song_valid = torch.arange(n_pad, device=sh.device) < len(g)
            sh.counts = sh.row_valid = None
            if alpha != 0.0:
                cpad = np.zeros(n_pad, np.int64)
                cpad[: len(g)] = loc_counts
                sh.counts = torch.from_numpy(cpad).to(sh.device)
                sh.row_valid = torch.from_numpy(build_row_valid(
                    loc_counts, self.R, pad, n_pad * self.R)).to(sh.device)
        # int8: one scale over every shard's copy, as JAX quantizes the stack
        amax = max((float(np.abs(c).max()) for c in coarse_host if c.size), default=0.0)
        for sh, coarse in zip(self.shards, coarse_host):
            if cdt == torch.int8:
                coarse = quantize_coarse_int8(coarse, amax)
            sh.coarse = _upload(coarse, cdt, sh.device)

    def _build_align(self, shard_rows) -> None:
        pad = self.pad
        self.R = -(-(pad + self.lmax) // 8) * 8
        rows = self.songs_max * self.R  # the kernel reads rows >= N as zero
        for sh, (loc_emb, loc_counts) in zip(self.shards, shard_rows):
            db = np.zeros((rows, self.d), dtype=np.float32)
            if len(loc_counts):
                db[song_rows(loc_counts, self.R, pad)] = loc_emb
            sh.db = _upload(db, self.db_dtype, sh.device)
            sh.row_valid = None
            if self.score_alpha != 0.0:
                sh.row_valid = torch.from_numpy(
                    build_row_valid(loc_counts, self.R, pad, rows)).to(sh.device)

    def _build_topk(self, shard_rows, groups, counts) -> None:
        rows_max = max(max((int(counts[g].sum()) for g in groups), default=1), 8)
        for sh, g, (loc_emb, loc_counts) in zip(self.shards, groups, shard_rows):
            db = np.zeros((rows_max, self.d), dtype=np.float32)
            db[: loc_emb.shape[0]] = loc_emb
            # the songs, zero-length padding songs, then one more song over
            # the zero rows past the shard's: hits on those rows land there
            # and are dropped, as JAX's out-of-range segment drops them
            song_pos = np.zeros(self.songs_max + 2, np.int64)
            song_pos[1 : len(g) + 1] = np.cumsum(loc_counts)
            song_pos[len(g) + 1 : -1] = loc_emb.shape[0]
            song_pos[-1] = rows_max
            sh.topk = TopkEngine(db, song_pos, top_k=self.top_k,
                                 frame_shift_mul=self.frame_shift_mul,
                                 score_alpha=self.score_alpha, score_dtype=self.db_dtype,
                                 device=sh.device)

    def resident_bytes(self) -> list[int]:
        """Bytes of each shard's device-resident layouts."""
        names = {"screen": ("db3", "coarse"), "align": ("db",)}.get(self.engine)
        out = []
        for sh in self.shards:
            ts = [getattr(sh, n) for n in names] if names else [sh.topk._db]
            out.append(sum(t.numel() * t.element_size() for t in ts))
        return out

    # ------------------------------------------------------------ helpers
    def _lead(self, tensors) -> torch.Tensor:
        """Per-shard tensors of one shape -> [n_shards, ...] on the lead
        device (the copies queue behind each shard's work)."""
        lead = self.devices[0]
        return torch.stack([t.to(lead, non_blocking=True) for t in tensors])

    def _merge_top1(self, val, slot, off):
        """[n_shards, n] per-shard top-1s -> the global one: the first
        maximum, the lower shard first.  Returns (val [n], flat [n] int64,
        off [n] int32) on the lead device."""
        si = val.argmax(dim=0)
        b = torch.arange(val.shape[1], device=val.device)
        return (val[si, b], si * self.songs_max + slot[si, b].long(),
                off[si, b].int())

    def _chunk(self, S: int) -> int:
        if self.engine == "screen":
            return stage2_chunk(self.top_m, self.R, S, self.d,
                                self.shards[0].db3.element_size(),
                                ScreenedAlignmentEngine.STAGE2_BYTES_CAP)
        return MAX_BATCH

    def _align_shard(self, sh, q, q_valid):
        """One shard's exhaustive tables: (best, argoff) [n, songs_max]."""
        S = q.shape[1]
        return alignment_core(
            sh.db, q.to(sh.device).to(self.db_dtype).contiguous(), R=self.R, S=S,
            n_songs=self.songs_max, score_alpha=self.score_alpha,
            row_valid=sh.row_valid,
            q_valid=None if q_valid is None else q_valid.to(sh.device))

    def _screen_shard(self, sh, q, lens):
        """One shard's stages 1+2: (cand, best, argoff) [n, M]."""
        q = q.to(sh.device)
        q_valid = None
        if self.score_alpha != 0.0:
            q_valid = (torch.arange(q.shape[1], device=sh.device)[None, :]
                       < lens.to(sh.device)[:, None]).float()
        return screen_core(sh.db3, sh.coarse, q, sh.song_valid, k=self.screen_k,
                           M=self.top_m, score_alpha=self.score_alpha, pad=self.pad,
                           counts=sh.counts, q_valid=q_valid)

    def _rescue_shard(self, sh, q, lens):
        """One shard's stage-3 tables: (best, argoff) [n, songs_max]."""
        return rescue_tables(sh.db3, q.to(sh.device), lens.to(sh.device),
                             score_alpha=self.score_alpha, row_valid=sh.row_valid)

    # ------------------------------------------------------------ top-1
    def _rescue_top1(self, q: torch.Tensor, inv: float):
        """Stage 3 of the top-1 path for queries q [e, S, d] f32 on the lead
        device: every shard's exhaustive scan, its local top-1 over real
        slots (the first best), then the merge of the mean scores."""
        lens = torch.full((q.shape[0],), q.shape[1], dtype=torch.int64)
        val, slot, off = [], [], []
        for sh in self.shards:
            with _on(sh.device):
                best, argoff = self._rescue_shard(sh, q, lens)
                best = torch.where(sh.song_valid[None, :], best, -torch.inf)
                s = best.argmax(dim=1, keepdim=True)
                val.append(best.gather(1, s)[:, 0] * inv)
                slot.append(s[:, 0])
                off.append(argoff.gather(1, s)[:, 0] - self.pad)
        return self._merge_top1(self._lead(val), self._lead(slot), self._lead(off))

    def search_top1_device(self, qpad, rescued: bool = True):
        """qpad [B, S, d] (host array or tensor, full-length queries) ->
        device (score [B] f32 = best sum / S, flat_idx [B] int64, offset [B]
        int32, pad-corrected: DB-hop units from the song start) on the lead
        device; map flat_idx with :meth:`flat_to_song`.

        On the screen engine with a rescue cut and ``rescued``, a query
        whose merged stages-1+2 score falls below the cut is rescored on
        every shard (one host sync per dispatch chunk reads which);
        ``rescued=False`` gives the bare stages 1+2."""
        if self.engine == "topk":
            raise ValueError("the topk engine has no top-1 path (query_batch)")
        q_all = torch.as_tensor(qpad, dtype=torch.float32).to(self.devices[0])
        B, S, _ = q_all.shape
        inv = 1.0 / S
        gate = (rescued and self.engine == "screen" and self.rescue_tau is not None
                and self.n_songs)
        q_valid = None
        if self.engine == "align" and self.score_alpha != 0.0:
            q_valid = torch.ones(S, min(B, MAX_BATCH))
        lens = torch.full((B,), S, dtype=torch.int64)
        chunk = self._chunk(S)
        outs = []
        for b0 in range(0, B, chunk):
            q = q_all[b0 : b0 + chunk]
            val, slot, off = [], [], []
            for sh in self.shards:
                with _on(sh.device):
                    if self.engine == "screen":
                        cand, best, argoff = self._screen_shard(sh, q, lens[: len(q)])
                    else:
                        best, argoff = self._align_shard(
                            sh, q, None if q_valid is None else q_valid[:, : len(q)])
                        cand = None
                    sc = best * inv
                    m = sc.argmax(dim=1, keepdim=True)
                    val.append(sc.gather(1, m)[:, 0])
                    slot.append(m[:, 0] if cand is None else cand.gather(1, m)[:, 0])
                    off.append(argoff.gather(1, m)[:, 0] - self.pad)
            top = self._merge_top1(self._lead(val), self._lead(slot), self._lead(off))
            if gate:
                esc = (top[0] < self.rescue_tau).nonzero()[:, 0]  # the chunk's one sync
                if len(esc):
                    get_logger().info(
                        "sharded screen top-1 rescue: %d/%d queries below tau=%.3f "
                        "rescored exhaustively", len(esc), len(q), self.rescue_tau)
                    for t, r in zip(top, self._rescue_top1(q[esc], inv)):
                        t[esc] = r.to(t.dtype)
            outs.append(top)
        return tuple(torch.cat(parts) for parts in zip(*outs))

    def search_top1_rescued(self, qpad):
        """The rescued top-1 answers on the host: (score [B], flat_idx [B],
        offset [B]) as numpy arrays, equal to ``query_batch``'s argmax."""
        return tuple(x.cpu().numpy() for x in self.search_top1_device(qpad))

    def flat_to_song(self, flat_idx) -> np.ndarray:
        """Map flat (shard * songs_max + slot) indices to global song ids."""
        if isinstance(flat_idx, torch.Tensor):
            flat_idx = flat_idx.cpu().numpy()
        return self.song_map.reshape(-1)[np.asarray(flat_idx)]

    # ------------------------------------------------------------ tables
    def query_batch(self, queries, pad_to: int | None = None
                    ) -> tuple[np.ndarray, np.ndarray]:
        """Returns (song_max [B, n_songs], song_time [B, n_songs]) in
        GLOBAL song order (padding slots dropped): mean scores and offsets
        (DB-hop units; sub-hop for the topk engine)."""
        B = len(queries)
        if self.engine == "topk":
            out_max = np.full((B, self.n_songs), -np.inf, dtype=np.float32)
            out_time = np.zeros((B, self.n_songs), dtype=np.float32)
            for si, sh in enumerate(self.shards):
                with _on(sh.device):
                    smax, stime = sh.topk.search(list(queries))
                self._scatter(si, out_max, out_time, smax, stime)
            return out_max, out_time
        S = pad_to or max(q.shape[0] for q in queries)
        true_lens = np.asarray([q.shape[0] for q in queries])
        qpad = np.zeros((B, S, self.d), dtype=np.float32)
        for i, q in enumerate(queries):
            qpad[i, : q.shape[0]] = q
        lens_f = np.maximum(true_lens, 1).astype(np.float32)
        q_all = torch.from_numpy(qpad).to(self.devices[0])
        fill = 0.0 if self.engine == "screen" else -np.inf
        out_max = np.full((B, self.n_songs), fill, dtype=np.float32)
        out_time = np.zeros((B, self.n_songs), dtype=np.float32)
        chunk = self._chunk(S)
        for b0 in range(0, B, chunk):
            rows = np.arange(b0, min(B, b0 + chunk))
            q = q_all[b0 : rows[-1] + 1]
            lens = torch.from_numpy(true_lens[rows])
            if self.engine == "align":
                self._align_tables(q, lens, rows, lens_f, out_max, out_time)
            else:
                self._screen_tables(q, lens, rows, lens_f, out_max, out_time)
        return out_max, out_time

    def _scatter(self, si, out_max, out_time, smax, stime, rows=slice(None)):
        """Shard si's [n, songs_max(+)] tables into the global ones."""
        ids = self.song_map[si]
        real = ids >= 0
        out_max[rows, ids[real]] = smax[:, : self.songs_max][:, real]
        out_time[rows, ids[real]] = stime[:, : self.songs_max][:, real]

    def _align_tables(self, q, lens, rows, lens_f, out_max, out_time) -> None:
        q_valid = None
        if self.score_alpha != 0.0:
            q_valid = (torch.arange(q.shape[1])[:, None] < lens[None, :]).float()
        best, argoff = [], []
        for sh in self.shards:
            with _on(sh.device):
                b, o = self._align_shard(sh, q, q_valid)
                best.append(b)
                argoff.append(o)
        best = self._lead(best).cpu().numpy()  # one sync for every shard
        argoff = self._lead(argoff).cpu().numpy()
        for si in range(self.n_shards):
            self._scatter(si, out_max, out_time, best[si] / lens_f[rows, None],
                          (argoff[si] - self.pad).astype(np.float32), rows[:, None])

    def _screen_tables(self, q, lens, rows, lens_f, out_max, out_time) -> None:
        """Stages 1+2 per shard scattered into the global table (pruned
        songs keep (0, 0), the screened engine's convention), then the
        global rescue gate: a row whose best merged mean score is below the
        cut gets every shard's exhaustive table."""
        outs = []
        for sh in self.shards:
            with _on(sh.device):
                outs.append(self._screen_shard(sh, q, lens))
        cand, best, argoff = (self._lead(x).cpu().numpy() for x in zip(*outs))
        bidx = np.broadcast_to(rows[:, None], (len(rows), self.top_m))
        for si in range(self.n_shards):
            ids = self.song_map[si][cand[si]]  # [n, M]; -1 = padding
            ok = ids >= 0
            out_max[bidx[ok], ids[ok]] = (best[si] / lens_f[rows, None])[ok]
            out_time[bidx[ok], ids[ok]] = (argoff[si] - self.pad)[ok]
        if self.rescue_tau is None or not self.n_songs:
            return
        esc = np.nonzero((out_max[rows].max(axis=1) < self.rescue_tau)
                         & (lens.numpy() > 0))[0]
        if not len(esc):
            return
        get_logger().info("sharded screen rescue: %d/%d queries below tau=%.3f "
                          "rescored exhaustively", len(esc), len(rows), self.rescue_tau)
        qe, le = q[torch.from_numpy(esc).to(q.device)], lens[esc]
        rb, ro = [], []
        for sh in self.shards:
            with _on(sh.device):
                b, o = self._rescue_shard(sh, qe, le)
                rb.append(b)
                ro.append(o)
        rb = self._lead(rb).cpu().numpy()
        ro = self._lead(ro).cpu().numpy()
        for si in range(self.n_shards):
            self._scatter(si, out_max, out_time, rb[si] / lens_f[rows[esc], None],
                          (ro[si] - self.pad).astype(np.float32), rows[esc][:, None])
