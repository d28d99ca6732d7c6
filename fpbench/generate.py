"""The one generator of every cell's inputs, driven by a configuration file
(the catalogue and the encoder) and a traffic file (the queries).

Everything is drawn from ``--seed`` on the run's device, in a fixed order
and in a few large calls: the encoder's weights, the catalogue's random
unit rows, the source songs' audio, the query pool.  Host-side draws (the
pool's cycling order, the queries checked) come from a CPU generator of
the same seed.  Every seed gives the same sizes; only the values differ.

Traffic kinds:
  audio        10 s crops on the hop grid of ``source_songs`` synthetic
               songs (chords of 3-6 sines in the mel range changing every
               0.25-1 s over a -30 dB floor, int16), white noise at the SNRs
               of ``snr_db``, an equal share of the queries each; the source
               songs' rows are the encoder's.
  fingerprint  ``query_rows`` consecutive catalogue rows of a random song at
               a random offset, plus sigma N(0, 1) per component, renormalised
               (the JAX package's ``bench.py``).  Sigma is set from the
               cosine the query keeps with its source, about the score its
               best alignment reads: an ``escalated`` share of each SNR
               bucket of ``snr_db`` (equal buckets) gets a cosine in
               ``cosine_escalate``, under the screen's rescue gate, the rest
               one in ``cosine_pass``; each on an even grid over its range.
Every query's SNR, cosine or sigma is one value of a grid that is the same
for every seed; the seed only orders it.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from fpbench.reference import fpnet

AUDIO_SONGS = 32  # source songs synthesised a call
AUDIO_QUERIES = 512  # queries cropped a call


@dataclasses.dataclass
class Inputs:
    params: dict | None  # encoder weights by checkpoint name (audio traffic)
    catalogue: np.ndarray  # [n_songs, song_rows, d] float32 on the host
    source_audio: torch.Tensor | None  # [n_src, samples] int16 on the device
    pool: np.ndarray  # int16 [P, samples] audio or float32 [P, S, d] rows
    truth: np.ndarray  # [P, 2] int64: the source song and row offset
    order: np.ndarray  # [P] the pool's cycling order
    check: np.ndarray  # pool indices the comparison reads, in seed order


def song_samples(cfg: dict, rows: int) -> int:
    """Samples of audio that give exactly ``rows`` windows."""
    seg = fpnet.segment_samples(cfg)
    return (rows - 1) * hop_samples(cfg) + seg


def hop_samples(cfg: dict) -> int:
    return int(round(cfg["hop_size"] * cfg["sample_rate"]))


def draw_weights(cfg: dict, gen: torch.Generator, device) -> dict:
    """LeCun-normal conv and projector weights from one normal draw, zero
    biases, LayerNorm scale 1 and shift 0; float32, as the checkpoint
    stores them."""
    shapes = fpnet.param_shapes(cfg)
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.randn(total, generator=gen, device=device)
    params, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        if name.endswith("ln1.weight") or name.endswith("ln2.weight"):
            params[name] = torch.ones(shape, device=device)
        else:
            params[name] = flat[at : at + n].view(shape) * fpnet.init_std(name, shape)
        at += n
    return params


def unit_rows(n: int, d: int, gen: torch.Generator, device) -> torch.Tensor:
    """n random unit rows [n, d] float32 on the device."""
    x = torch.randn(n, d, generator=gen, device=device)
    return x.div_(torch.linalg.vector_norm(x, dim=1, keepdim=True))


def synth_songs(n: int, samples: int, cfg: dict, tr: dict, gen: torch.Generator,
                device) -> torch.Tensor:
    """n songs of chords, int16 [n, samples] on the device."""
    sr = cfg["sample_rate"]
    lo_s, hi_s = tr["chord_s"]
    n_chords = int(samples / sr / lo_s) + 2
    notes = tr["chord_notes"][1]
    dur = (lo_s + (hi_s - lo_s) * torch.rand(n, n_chords, generator=gen, device=device)) * sr
    ends = torch.cumsum(dur, dim=1)
    f_lo, f_hi = tr["note_hz"]
    freq = f_lo * (f_hi / f_lo) ** torch.rand(n, n_chords, notes, generator=gen, device=device)
    count = torch.randint(tr["chord_notes"][0], notes + 1, (n, n_chords), generator=gen,
                          device=device)
    phase = 2 * math.pi * torch.rand(n, n_chords, notes, generator=gen, device=device)
    floor = torch.randn(n, samples, generator=gen, device=device)
    amp = torch.arange(notes, device=device)[None, None, :] < count[:, :, None]
    amp = amp.float() / count[:, :, None].float().sqrt()
    out = torch.empty(n, samples, dtype=torch.int16, device=device)
    idx = torch.arange(samples, device=device, dtype=torch.float32)
    for s0 in range(0, n, AUDIO_SONGS):
        sl = slice(s0, s0 + AUDIO_SONGS)
        c = torch.searchsorted(ends[sl], idx.expand(ends[sl].shape[0], -1).contiguous(),
                               right=True).clamp(max=n_chords - 1)
        start = torch.where(c > 0, ends[sl].gather(1, (c - 1).clamp(min=0)), 0.0)
        local = ((idx[None, :] - start) / sr)[:, :, None]
        gi = c[:, :, None].expand(-1, -1, notes)
        x = (amp[sl].gather(1, gi) * torch.sin(
            2 * math.pi * freq[sl].gather(1, gi) * local + phase[sl].gather(1, gi))).sum(2)
        x = 0.1 * x / x.square().mean(dim=1, keepdim=True).sqrt()
        x = x + floor[sl] * (0.1 * 10 ** (tr["floor_db"] / 20))
        out[sl] = (x.clamp(-1, 1) * 32767).round().to(torch.int16)
    return out


def audio_queries(src: torch.Tensor, song: torch.Tensor, off: torch.Tensor, cfg: dict,
                  tr: dict, gen: torch.Generator) -> np.ndarray:
    """Crops of the source songs at row offsets ``off`` with white noise at
    an SNR drawn per query: int16 [P, samples] on the host."""
    hop = hop_samples(cfg)
    n = song_samples(cfg, tr["query_rows"])
    P = song.shape[0]
    snr = on_grid(tr["snr_db"], P, gen, src.device)
    noise = torch.randn(P, n, generator=gen, device=src.device)
    out = np.empty((P, n), np.int16)
    at = torch.arange(n, device=src.device)
    for q0 in range(0, P, AUDIO_QUERIES):
        sl = slice(q0, q0 + AUDIO_QUERIES)
        x = src[song[sl, None], off[sl, None] * hop + at[None, :]].float() / 32768.0
        p = x.square().mean(dim=1, keepdim=True)
        x = x + noise[sl] * (p / 10 ** (snr[sl, None] / 10)).sqrt()
        out[sl] = (x.clamp(-1, 1) * 32767).round().to(torch.int16).cpu().numpy()
    return out


def stratified(u: torch.Tensor) -> torch.Tensor:
    """The grid (i + 0.5) / n in the order of the draws u: every seed gets the
    same set of values, so the same work (the screen's rescue share follows
    the cosine), in another order."""
    rank = torch.empty_like(u)
    rank[u.argsort()] = torch.arange(u.numel(), device=u.device, dtype=u.dtype)
    return (rank + 0.5) / u.numel()


def on_grid(values: list, n: int, gen: torch.Generator, device) -> torch.Tensor:
    """n of ``values``, each an equal share (to one), in a seeded order."""
    grid = torch.tensor(values, dtype=torch.float32, device=device)
    return grid[torch.randperm(n, generator=gen, device=device) % len(values)]


def escalated_count(tr: dict, P: int) -> int:
    """Queries of a pool of P under the rescue gate: each SNR bucket's
    measured share of its equal part of the pool."""
    part = P / len(tr["snr_db"])
    return int(sum(round(share * part) for share in tr["escalated"]))


def query_cosines(tr: dict, P: int, gen: torch.Generator, device) -> torch.Tensor:
    """[P] cosines: ``escalated_count`` on an even grid over
    ``cosine_escalate``, the rest over ``cosine_pass``, in a seeded order."""
    if len(tr["escalated"]) != len(tr["snr_db"]):
        raise ValueError("one escalated share a SNR bucket")
    M = escalated_count(tr, P)
    u = stratified(torch.rand(P, generator=gen, device=device))
    lo_e, hi_e = tr["cosine_escalate"]
    lo_p, hi_p = tr["cosine_pass"]
    esc = torch.zeros(P, dtype=torch.bool, device=device)
    esc[torch.randperm(P, generator=gen, device=device)[:M]] = True
    cos = torch.empty(P, device=device)
    # each group's own grid: its ranks among the draws of the group
    for mask, lo, hi in ((esc, lo_e, hi_e), (~esc, lo_p, hi_p)):
        if mask.any():
            cos[mask] = lo + (hi - lo) * stratified(u[mask])
    return cos


def fingerprint_queries(rows: torch.Tensor, song: torch.Tensor, off: torch.Tensor,
                        tr: dict, gen: torch.Generator) -> np.ndarray:
    """``query_rows`` rows of each song from ``off`` plus sigma N(0, 1),
    renormalised, sigma from the query's cosine with its source
    (1 / sqrt(1 + d sigma^2)): float32 [P, S, d] on the host."""
    S = tr["query_rows"]
    P, d = song.shape[0], rows.shape[2]
    cos = query_cosines(tr, P, gen, rows.device)
    sigma = ((1.0 / cos.square() - 1.0) / d).sqrt()
    noise = torch.randn(P, S, d, generator=gen, device=rows.device)
    q = rows[song[:, None], off[:, None] + torch.arange(S, device=rows.device)[None, :]]
    q = q + sigma[:, None, None] * noise
    return (q / torch.linalg.vector_norm(q, dim=2, keepdim=True)).cpu().numpy()


def make_inputs(cfg: dict, tr: dict, seed: int, device) -> Inputs:
    """Every input of one run of a cell, from ``seed``."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    host = torch.Generator().manual_seed(seed)
    d = cfg["model"]["d"]
    n_songs, C = cfg["n_songs"], cfg["song_rows"]
    S, P = tr["query_rows"], tr["pool"]
    audio = tr["kind"] == "audio"
    if tr["kind"] not in ("audio", "fingerprint"):
        raise ValueError("unknown traffic kind %r" % tr["kind"])
    params = draw_weights(cfg, gen, device) if audio else None
    rows = unit_rows(n_songs * C, d, gen, device).view(n_songs, C, d)
    n_src = tr["source_songs"] if audio else n_songs
    if n_src > n_songs:
        raise ValueError("more source songs than the catalogue holds")
    song = torch.randint(0, n_src, (P,), generator=gen, device=device)
    off = torch.randint(0, C - S + 1, (P,), generator=gen, device=device)
    src = None
    if audio:
        src = synth_songs(n_src, song_samples(cfg, C), cfg, tr, gen, device)
        pool = audio_queries(src, song, off, cfg, tr, gen)
    else:
        pool = fingerprint_queries(rows, song, off, tr, gen)
    catalogue = rows.cpu().numpy()
    del rows
    order = torch.randperm(P, generator=host).numpy()
    check = torch.randperm(P, generator=host).numpy()
    truth = torch.stack([song, off], dim=1).cpu().numpy()
    return Inputs(params, catalogue, src, pool, truth, order, check)
