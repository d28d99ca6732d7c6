"""Self-contained landmark (constellation-hash) fingerprinter.

A copy of ``pfann_tpu/landmark/core.py``, so that the port imports
nothing of the JAX package.

The reference's thesis ensemble fuses its NN scores with a *landmark*
system that lives in an external repo (`../pfa`, invoked as a black box
by testall.sh and read back through ensemble/lmscore.py).  That repo is
not part of the reference snapshot, so this module provides an
independent implementation of the classic peak-pair scheme (Wang 2003)
with the same CLI/output contracts the ensemble tooling expects:

  * `<result>.txt`       TSV  query \t answer
  * `<result>.txt.csv`   query, answer, time  (tools/accuracy.py input)
  * `<result>.txt.bin`   int32 [n_query, n_songs, 2] — column 0 = best
    offset (frames), column 1 = vote score (ensemble/lmscore.py reads
    column 1)

Design (host-side numpy; the landmark system is an offline CPU baseline
in the thesis too — BASELINE.md row "Landmark system", hardware CPU):

  1. log-magnitude STFT;
  2. constellation = local maxima over a (freq x time) neighbourhood,
     magnitude-gated relative to the global median;
  3. anchor->target pairs in a forward target zone, packed into int32
     hashes  (f_anchor [10b: rfft(1024) -> 513 bins] | df+256 [9b] |
     dt [6b]);
  4. index = hashes sorted once, (song, t_anchor) payloads alongside;
     queries do a searchsorted range per hash and vote on
     (song, t_db - t_query); the winning histogram bin is the score and
     its offset is the alignment.
"""

from __future__ import annotations

import json
import os

import numpy as np
from scipy.ndimage import maximum_filter

N_FFT = 1024
HOP = 256
# constellation extraction
NEIGH_F = 21  # local-max neighbourhood (freq bins)
NEIGH_T = 9   # local-max neighbourhood (frames)
MIN_GAIN = 2.0  # peak must sit this far (in log units) above the median
# pairing target zone
FANOUT = 12
DT_MIN, DT_MAX = 1, 63        # frames ahead (6 bits)
DF_MAX = 255                  # |freq delta| bound (9 bits signed)


def spectrogram(wav: np.ndarray, n_fft: int = N_FFT, hop: int = HOP
                ) -> np.ndarray:
    """log-magnitude STFT [n_bins, n_frames] of a mono float signal."""
    wav = np.asarray(wav, dtype=np.float32).reshape(-1)
    if wav.shape[0] < n_fft:
        wav = np.pad(wav, (0, n_fft - wav.shape[0]))
    n_frames = 1 + (wav.shape[0] - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = wav[idx] * np.hanning(n_fft).astype(np.float32)[None, :]
    mag = np.abs(np.fft.rfft(frames, axis=1)).T  # [n_bins, n_frames]
    return np.log(mag + 1e-6)


def find_peaks(spec: np.ndarray) -> np.ndarray:
    """Constellation points [(f, t)] int32, time-sorted.

    A point survives if it is the maximum of its (NEIGH_F x NEIGH_T)
    neighbourhood and exceeds the spectrogram median by MIN_GAIN — an
    absolute-free gate that adapts to recording level.
    """
    if spec.size == 0:
        return np.zeros((0, 2), dtype=np.int32)
    local_max = spec == maximum_filter(spec, size=(NEIGH_F, NEIGH_T),
                                       mode="nearest")
    gate = np.median(spec) + MIN_GAIN
    f, t = np.nonzero(local_max & (spec > gate))
    order = np.argsort(t, kind="stable")
    return np.stack([f[order], t[order]], axis=1).astype(np.int32)


def pair_peaks(peaks: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized anchor->target pairing of a time-sorted constellation.

    Semantics identical to the per-peak scan (each anchor takes its first
    FANOUT time-ordered targets with dt in [DT_MIN, DT_MAX] and
    |df| <= DF_MAX): the target window per anchor comes from two
    searchsorteds, the ragged (anchor, target) expansion is the
    cumsum/arange trick, and the fanout cap is a running count of valid
    pairs inside each anchor's group (cumsum minus the group's base).
    ~100x the pure-Python loop at real-song peak densities — hash
    extraction over an fma_full-scale corpus was the landmark system's
    days-of-CPU hot loop (VERDICT r2 weak #5).
    """
    n = peaks.shape[0]
    if n < 2:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    f, t = peaks[:, 0].astype(np.int64), peaks[:, 1].astype(np.int64)
    lo = np.searchsorted(t, t + DT_MIN, side="left")
    hi = np.searchsorted(t, t + DT_MAX, side="right")
    lo = np.maximum(lo, np.arange(n) + 1)  # targets strictly after self
    cnt = np.maximum(hi - lo, 0)
    total = int(cnt.sum())
    if total == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    anchor = np.repeat(np.arange(n), cnt)
    base = np.minimum(np.cumsum(cnt) - cnt, total - 1)  # clip empty-tail
    # groups (cnt=0 repeats drop them; the clip only keeps indexing legal)
    j = lo[anchor] + (np.arange(total) - np.repeat(base, cnt))
    df = f[j] - f[anchor]
    valid = np.abs(df) <= DF_MAX
    # fanout cap: 1-based rank of each VALID pair within its anchor
    # group = inclusive-cumsum(valid) rebased to the group's first slot
    vcum = np.cumsum(valid)
    rank = vcum - np.repeat(vcum[base] - valid[base], cnt)
    keep = valid & (rank <= FANOUT)
    ai, ji = anchor[keep], j[keep]
    h = (f[ai] << 15) | ((f[ji] - f[ai] + 256) << 6) | (t[ji] - t[ai])
    return h.astype(np.int32), t[ai].astype(np.int32)


def extract_hashes(wav: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(hashes int32 [n], t_anchor int32 [n]) for one mono signal."""
    return pair_peaks(find_peaks(spectrogram(wav)))


class LandmarkIndex:
    """Hash-sorted inverted index over a song collection."""

    def __init__(self, hashes: np.ndarray, songs: np.ndarray,
                 anchors: np.ndarray, n_songs: int,
                 song_list: list[str] | None = None):
        order = np.argsort(hashes, kind="stable")
        self.hashes = np.ascontiguousarray(hashes[order])
        self.songs = np.ascontiguousarray(songs[order])
        self.anchors = np.ascontiguousarray(anchors[order])
        self.n_songs = n_songs
        self.song_list = song_list or []

    # -------------------------------------------------- construction
    @classmethod
    def build(cls, signals, song_list=None, extractor=None):
        """signals: iterable of mono arrays (one per song; float32, or
        int16 for the device path's half-size transfers).  extractor:
        an optional landmark.device.DevicePeakExtractor (the port's,
        in torch ops) — songs are then
        buffered into accelerator batches for the spectrogram/peak
        stage (pairing stays host-side either way)."""
        all_h, all_s, all_t = [], [], []
        n = 0

        def add(song_id, h, t):
            all_h.append(h)
            all_s.append(np.full(h.shape[0], song_id, dtype=np.int32))
            all_t.append(t)

        if extractor is None:
            for song_id, wav in enumerate(signals):
                add(song_id, *extract_hashes(wav))
                n = song_id + 1
        else:
            buf: list[np.ndarray] = []

            def flush():
                nonlocal n
                for peaks in extractor.extract(buf):
                    add(n, *pair_peaks(peaks))
                    n += 1
                buf.clear()

            for wav in signals:
                buf.append(np.asarray(wav))
                if len(buf) >= extractor.batch:
                    flush()
            if buf:
                flush()
        cat = lambda xs, d: (np.concatenate(xs) if xs else
                             np.zeros(0, dtype=d))
        return cls(cat(all_h, np.int32), cat(all_s, np.int32),
                   cat(all_t, np.int32), n, song_list)

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        np.savez(os.path.join(path, "landmarks.npz"),
                 hashes=self.hashes, songs=self.songs, anchors=self.anchors)
        with open(os.path.join(path, "songList.txt"), "w") as f:
            f.writelines(s + "\n" for s in self.song_list)
        with open(os.path.join(path, "lm_meta.json"), "w") as f:
            json.dump({"version": 1, "n_songs": self.n_songs,
                       "n_fft": N_FFT, "hop": HOP}, f)

    @classmethod
    def load(cls, path: str) -> "LandmarkIndex":
        z = np.load(os.path.join(path, "landmarks.npz"))
        with open(os.path.join(path, "lm_meta.json")) as f:
            meta = json.load(f)
        with open(os.path.join(path, "songList.txt")) as f:
            song_list = [line.rstrip("\n") for line in f]
        idx = cls.__new__(cls)
        idx.hashes = z["hashes"]
        idx.songs = z["songs"]
        idx.anchors = z["anchors"]
        idx.n_songs = meta["n_songs"]
        idx.song_list = song_list
        return idx

    # -------------------------------------------------- query
    def query(self, wav: np.ndarray) -> tuple[int, np.ndarray]:
        """Returns (best_song, table int32 [n_songs, 2]) — table column 0
        is the winning time offset in frames (t_db - t_query, clipped to
        >= 0), column 1 the vote count of that offset's histogram bin."""
        return self.query_hashes(*extract_hashes(wav))

    def query_hashes(self, h: np.ndarray, tq: np.ndarray
                     ) -> tuple[int, np.ndarray]:
        """query() on precomputed (hashes, t_anchor) — the entry point
        for batched device extraction (lm_matcher batches the
        spectrogram/peak stage across queries, then votes per query)."""
        table = np.zeros((self.n_songs, 2), dtype=np.int32)
        if h.shape[0] == 0 or self.hashes.shape[0] == 0:
            return -1, table
        lo = np.searchsorted(self.hashes, h, side="left")
        hi = np.searchsorted(self.hashes, h, side="right")
        counts = hi - lo
        m = counts.sum()
        if m == 0:
            return -1, table
        # flatten all matches: row r of expand maps to query hash k(r)
        k = np.repeat(np.arange(h.shape[0]), counts)
        pos = np.concatenate([np.arange(a, b) for a, b in zip(lo, hi)
                              if b > a])
        song = self.songs[pos].astype(np.int64)
        # +DT_MAX keeps offsets positive for the packed histogram; query
        # time never exceeds the song tail by more than the target zone
        dt = (self.anchors[pos].astype(np.int64) - tq[k]
              + DT_MAX)
        valid = dt >= 0
        song, dt = song[valid], dt[valid]
        packed = song * (1 << 32) + dt
        uniq, votes = np.unique(packed, return_counts=True)
        u_song = (uniq >> 32).astype(np.int64)
        u_dt = (uniq & 0xFFFFFFFF).astype(np.int64) - DT_MAX
        # per-song argmax over its histogram bins (songs are sorted in
        # uniq): max per group via maximum.reduceat, then the FIRST bin
        # attaining it via minimum.reduceat over masked positions —
        # matching np.argmax's first-occurrence convention
        starts = np.nonzero(np.diff(u_song, prepend=-1))[0]
        gmax = np.maximum.reduceat(votes, starts)
        gid = np.cumsum(np.diff(u_song, prepend=-1) != 0) - 1
        pos = np.where(votes == gmax[gid], np.arange(votes.shape[0]),
                       votes.shape[0])
        best = np.minimum.reduceat(pos, starts)
        g_song = u_song[starts]
        table[g_song, 0] = np.maximum(u_dt[best], 0)
        table[g_song, 1] = votes[best]
        return int(np.argmax(table[:, 1])), table
