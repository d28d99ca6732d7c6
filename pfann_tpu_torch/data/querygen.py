"""Host-side evaluation-clip synthesis: the building blocks behind
``genquery.py``, ``genquery_naf.py`` and ``denoise/createdataset.py``.

A copy of ``pfann_tpu/data/querygen.py``, so that the port imports
nothing of the JAX package.

Behavioral parity targets (re-derived, not transcribed): reference
genquery.py:29-99 (crop -> mono/resample -> noise at a uniform SNR ->
room x mic IR in the frequency domain -> inf-norm), genquery_naf.py:52-79
(per-1 s-segment independent shifts + per-segment noise/IRs), and
denoise/createdataset.py:61-104 (one IR draw applied to music and noise
separately).  The pieces are deliberately decomposed differently from the
reference's per-script monoliths:

  * :class:`ClipSampler` — owns the "cut a clip, keep reverb context"
    geometry, at the source rate, then resamples once.
  * :class:`ReverbBank` — owns IR *drawing* separately from *applying*,
    so one draw can hit several signals (the denoise triplet case) or a
    whole row batch (the NAF per-segment case).
  * :func:`synthesize_query` / :func:`synthesize_query_naf` — the two
    query recipes, shared by the CLIs.

Determinism contract: every function takes an explicit
``np.random.Generator``; the CLIs seed one per query (9000 + index),
mirroring the reference's reproducible-eval convention (genquery.py:43).
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np

from pfann_tpu_torch.audio.io import get_audio
from pfann_tpu_torch.audio.resample import resample
from pfann_tpu_torch.data.ir import AIR, MicIRP
from pfann_tpu_torch.data.noise import NoiseData


def fft_block_len(params: dict[str, Any], clip_seconds: float) -> int:
    """Smallest power-of-two FFT length covering context + clip + both IR
    tails (so circular convolution never wraps into the kept window)."""
    need = (
        params["pad_start"] + clip_seconds
        + params["air"]["length"] + params["micirp"]["length"]
    ) * params["sample_rate"]
    n = 2048
    while n < need:
        n *= 2
    return n


def load_eval_corpora(
    params: dict[str, Any],
    split: str,
    fftconv_n: int,
    *,
    noise_dir: str | None = None,
    air_dir: str | None = None,
    mic_dir: str | None = None,
) -> tuple[NoiseData | None, AIR | None, MicIRP | None]:
    """Noise/room-IR/mic-IR corpora for one split.  Directories default
    to the config's; passing an explicit empty string disables a member
    (the denoise CLI exposes them as optional flags)."""
    rate = params["sample_rate"]

    def pick(flag, key):
        if flag is not None:
            return flag or None
        return params[key].get("dir")

    nd, ad, md = (
        pick(noise_dir, "noise"), pick(air_dir, "air"), pick(mic_dir, "micirp")
    )
    noise = air = micirp = None
    if nd:
        noise = NoiseData(
            noise_dir=nd, list_csv=params["noise"][split],
            sample_rate=rate, cache_dir=params["cache_dir"],
        )
    if ad:
        air = AIR(
            air_dir=ad, list_csv=params["air"][split],
            length=params["air"]["length"], fftconv_n=fftconv_n,
            sample_rate=rate,
        )
    if md:
        micirp = MicIRP(
            mic_dir=md, list_csv=params["micirp"][split],
            length=params["micirp"]["length"], fftconv_n=fftconv_n,
            sample_rate=rate,
        )
    return noise, air, micirp


class ClipSampler:
    """Cuts ``clip_seconds`` of audio with ``context_seconds`` of extra
    left context (headroom for reverb tails), mono, at the pipeline rate.

    The crop position is drawn at the *source* rate so the ground-truth
    offset is exact regardless of resampling.
    """

    def __init__(self, sample_rate: int, clip_seconds: float,
                 context_seconds: float):
        self.rate = sample_rate
        self.clip_seconds = clip_seconds
        self.context_seconds = context_seconds
        self.n_clip = int(sample_rate * clip_seconds)
        self.n_ctx = int(sample_rate * context_seconds)

    def sample(self, rng: np.random.Generator, path: str
               ) -> tuple[np.ndarray, float]:
        """Returns (mono clip [n_ctx + n_clip] float32, clip start in
        seconds within the source file)."""
        wav, src_rate = get_audio(path)
        want = int(src_rate * self.clip_seconds)
        ctx = int(src_rate * self.context_seconds)
        have = wav.shape[1]
        start = int(rng.integers(0, have - want)) if have > want else 0
        lo = start - ctx
        mono = wav[:, max(lo, 0) : start + want].mean(axis=0)
        head = max(-lo, 0)
        tail = max(want - have, 0)
        if head or tail:
            mono = np.concatenate(
                [np.zeros(head, mono.dtype), mono, np.zeros(tail, mono.dtype)]
            )
        out = resample(mono, src_rate, self.rate)
        n_out = self.n_ctx + self.n_clip
        if out.shape[0] < n_out:
            out = np.pad(out, (0, n_out - out.shape[0]))
        return out[:n_out].astype(np.float32), start / src_rate


class ReverbBank:
    """Room x microphone impulse responses as frequency-domain
    multipliers.  ``draw*`` picks responses; :meth:`apply` convolves —
    separated so one draw can be applied to several signals."""

    def __init__(self, air: AIR | None, micirp: MicIRP | None, fftconv_n: int):
        self.air = air
        self.micirp = micirp
        self.n = fftconv_n

    def draw(self, rng: np.random.Generator
             ) -> tuple[np.ndarray | None, str]:
        """One combined multiplier (or None when both banks are off) and
        the room name for the ground-truth record."""
        mult, room = None, ""
        if self.air is not None:
            mult, room = self.air.random_choose_name(rng)
        if self.micirp is not None:
            mic = self.micirp.random_choose(rng, 1)[0]
            mult = mic if mult is None else mult * mic
        return mult, room

    def draw_rows(self, rng: np.random.Generator, n_rows: int
                  ) -> np.ndarray | None:
        """Independent multipliers per row (NAF per-segment protocol)."""
        mult = None
        if self.air is not None:
            mult = self.air.data[rng.integers(0, self.air.data.shape[0], n_rows)]
        if self.micirp is not None:
            mic = self.micirp.random_choose(rng, n_rows)
            mult = mic if mult is None else mult * mic
        return mult

    def apply(self, x: np.ndarray, mult: np.ndarray | None,
              keep: tuple[int, int]) -> np.ndarray:
        """FFT-convolve ``x`` (last axis) with a drawn multiplier and
        slice ``keep`` from the result.  mult=None still applies the
        keep-window (a clean pass-through)."""
        a, b = keep
        if mult is None:
            return np.asarray(x[..., a:b], dtype=np.float64)
        spec = np.fft.rfft(x, self.n)
        return np.fft.irfft(spec * mult, self.n)[..., a:b]


def peak_normalize(x: np.ndarray) -> np.ndarray:
    peak = float(np.max(np.abs(x))) if x.size else 0.0
    return x / peak if peak > 0 else x


def synthesize_query(
    rng: np.random.Generator,
    path: str,
    sampler: ClipSampler,
    noise: NoiseData | None,
    reverb: ReverbBank,
    snr_range: tuple[float, float],
) -> tuple[np.ndarray, float, float, str]:
    """One reference-protocol query: crop -> noise -> reverb -> inf-norm.

    Returns (audio [n_clip] float32, clip start seconds, snr dB, room).
    """
    clip, t0 = sampler.sample(rng, path)
    snr = float("nan")
    if noise is not None:
        mixed, _, drawn = noise.add_noises(
            rng, clip[None], snr_range[0], snr_range[1], out_name=True
        )
        clip, snr = mixed[0], float(drawn[0])
    mult, room = reverb.draw(rng)
    out = reverb.apply(clip, mult, (sampler.n_ctx, sampler.n_ctx + sampler.n_clip))
    return peak_normalize(out).astype(np.float32), t0, snr, room


def segment_grid(
    rng: np.random.Generator, audio: np.ndarray, seg: int, max_shift: int
) -> np.ndarray:
    """Cut ``audio`` into consecutive ``seg``-sample rows, each row's
    window independently jittered by U[-max_shift, max_shift] samples and
    de-meaned (the NAF evaluation protocol, genquery_naf.py:52-66)."""
    n_rows = max(audio.shape[0] // seg, 1)
    jitter = rng.integers(-max_shift, max_shift + 1, n_rows)
    rows = np.zeros((n_rows, seg), dtype=audio.dtype)
    for r in range(n_rows):
        at = r * seg + int(jitter[r])
        src = audio[max(at, 0) : at + seg]
        rows[r, max(-at, 0) : max(-at, 0) + src.shape[0]] = src
    return rows - rows.mean(axis=1, keepdims=True)


class QuerySetWriter:
    """Owns the evaluation-set directory contract shared by both query
    CLIs: ``q%04d_<source>_snr<k>_<room>.wav`` files, ``expected.csv``
    ground truth (query, answer, time, snr, reverb), ``list.txt`` of
    absolute-or-relative wav paths, and a ``configs.json`` snapshot
    (reference genquery.py:148-168 layout)."""

    HEADER = ["query", "answer", "time", "snr", "reverb"]

    def __init__(self, out_dir: str, sample_rate: int):
        import csv

        os.makedirs(out_dir, exist_ok=True)
        self.out_dir = out_dir
        self.rate = sample_rate
        self._gt = open(
            os.path.join(out_dir, "expected.csv"), "w",
            encoding="utf8", newline="\n",
        )
        self._csv = csv.writer(self._gt)
        self._csv.writerow(self.HEADER)
        self._list = open(
            os.path.join(out_dir, "list.txt"), "w", encoding="utf8"
        )

    def add(self, index: int, source: str, audio: np.ndarray,
            t0: float, snr: float, room: str) -> str:
        from pfann_tpu_torch.audio.io import write_wav

        stem = os.path.splitext(os.path.basename(source))[0]
        tag = "%d" % np.floor(snr) if np.isfinite(snr) else "na"
        wav_name = "q%04d_%s_snr%s_%s.wav" % (index + 1, stem, tag, room)
        self._csv.writerow([wav_name, source, t0, snr, room])
        path = os.path.join(self.out_dir, wav_name)
        write_wav(path, audio, self.rate)
        self._list.write(path + "\n")
        return wav_name

    def close(self, params: dict[str, Any]) -> None:
        import json

        self._gt.close()
        self._list.close()
        with open(os.path.join(self.out_dir, "configs.json"), "w") as f:
            json.dump(params, f, indent=2)


def confirm_overwrite(out_dir: str, assume_yes: bool) -> bool:
    """Interactive overwrite guard shared by the query CLIs."""
    if assume_yes or not os.path.exists(out_dir):
        return True
    answer = input("Folder %s exists, overwrite anyway? (y/n) " % out_dir)
    while answer not in {"y", "n"}:
        answer = input("Please enter y or n: ")
    return answer == "y"


def synthesize_query_naf(
    rng: np.random.Generator,
    path: str,
    params: dict[str, Any],
    noise: NoiseData | None,
    reverb: ReverbBank,
    snr_range: tuple[float, float],
) -> np.ndarray:
    """NAF-style query: whole file, per-segment independent shifts,
    per-segment noise and IR draws, flattened back to one waveform."""
    wav, src_rate = get_audio(path)
    rate = params["sample_rate"]
    audio = resample(wav.mean(axis=0), src_rate, rate)
    seg = int(rate * params["segment_size"])
    max_shift = int(rate * params["time_offset"]) - seg
    rows = segment_grid(rng, audio, seg, max_shift)
    if noise is not None:
        rows = noise.add_noises(rng, rows, snr_range[0], snr_range[1])
    mult = reverb.draw_rows(rng, rows.shape[0])
    rows = reverb.apply(rows, mult, (0, seg))
    return peak_normalize(rows.reshape(-1)).astype(np.float32)
