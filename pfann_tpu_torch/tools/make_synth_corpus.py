"""Generate a self-contained synthetic dataset for the per-SNR accuracy
harness (train / genall.sh / testall.sh run end-to-end with zero external
data), on the port's host modules.

Layout written under --root (default out/synth_dataset):
    music/s####.wav     structured "songs" (chord sequences + texture)
    noise/n###.wav      noise corpus (white / pink / AM-band / hum)
    air/room#.mat       room IRs in the Aachen .mat format (h_air key)
    micirp/mic#.wav     microphone IRs
    lists/music_train.csv / music_val.csv / music_test.csv
    lists/noise_train.csv / noise_val.csv
    lists/air_train.csv / air_val.csv / micirp_train.csv / micirp_val.csv
    lists/db.txt        DB build list (dummy songs + the test songs)

The companion configs are shipped in configs/synth.json and
configs/gentest_synth_snr*.json; testall.sh knows the dataset as
``synth``.  Mirrors the reference eval design (tools/fma_large.py:37-56:
a dummy-track DB + in-DB test tracks queried at every SNR).

    python -m pfann_tpu_torch.tools.make_synth_corpus --root out/synth_dataset

A copy of the JAX ``tools/make_synth_corpus.py`` over the port's
``audio/io.py``: the same seed writes the same WAVs, lists and IRs.
"""

from __future__ import annotations

import argparse
import csv
import os

import numpy as np

from pfann_tpu_torch.audio.io import write_wav

SR = 8000


def make_family(rng: np.random.Generator) -> dict:
    """A song FAMILY: a shared 'instrument + key + tempo' identity that
    several songs are written in.  v2 corpus design (VERDICT r2 next #2):
    round 1's generator drew every song from ONE discrete 36-note sine
    scale, which (a) collided landmark peak-pair hashes across the whole
    corpus (pure sines on a shared grid -> identical (f, df, dt) pairs)
    and (b) left the NN at 100 % song top-1 at 10 s (every song a
    distinctive broadband texture).  Families invert both: the scale
    root is CONTINUOUS (log-uniform) and per-family detuned, so peak
    bins are family-specific and landmark hashes discriminate; songs
    inside a family share scale, timbre, and tempo, so their 1 s
    segments are mutually confusable and the NN leaves the ceiling —
    the regime where the thesis's NN/landmark disagreement set is
    non-trivial (reference ensemble/svmtrain.py trains exactly there).
    """
    root = 150.0 * 2 ** rng.uniform(0.0, 1.0)  # continuous in [150, 300)
    # 12-TET-ish degrees over 3 octaves with per-family random detune
    degrees = np.arange(36) + rng.uniform(-0.45, 0.45, 36)
    return {
        "scale": root * 2 ** (degrees / 12.0),
        "n_partials": int(rng.integers(3, 9)),
        "decay": rng.uniform(0.6, 2.0),       # partial k amp ~ k^-decay
        "inharm": rng.uniform(0.0, 6e-4),     # f_k = f0 k sqrt(1+inharm k^2)
        "attack": rng.uniform(0.003, 0.02),   # s — sharp onsets anchor peaks
        "release": rng.uniform(0.12, 0.45),   # s — exponential ring-out
        "beat": rng.uniform(0.22, 0.55),      # s per grid slot
        "trem": rng.uniform(0.0, 0.25),
        "trem_hz": rng.uniform(2.0, 7.0),
    }


def synth_note(fam: dict, f0: float, dur: int,
               rng: np.random.Generator) -> np.ndarray:
    """One plucked note: harmonic stack with family timbre, fast attack,
    exponential release (transient-rich — the landmark constellation
    anchors on onsets; round 1's box-envelope steady sines gave it
    nothing time-localized to key on)."""
    tt = np.arange(dur, dtype=np.float32) / SR
    k = np.arange(1, fam["n_partials"] + 1, dtype=np.float32)
    fk = f0 * k * np.sqrt(1.0 + fam["inharm"] * k * k)
    ak = k ** -fam["decay"]
    ak = np.where(fk < SR / 2 - 100.0, ak, 0.0)  # band-limit
    ph = rng.uniform(0, 2 * np.pi, k.shape[0]).astype(np.float32)
    y = (ak[:, None] * np.sin(
        2 * np.pi * fk[:, None] * tt[None, :] + ph[:, None]
    )).sum(axis=0)
    env = (1.0 - np.exp(-tt / fam["attack"])) * np.exp(-tt / fam["release"])
    if fam["trem"] > 0:
        env = env * (1.0 + fam["trem"] * np.sin(
            2 * np.pi * fam["trem_hz"] * tt + rng.uniform(0, 6.28)
        ))
    return (y * env).astype(np.float32)


def make_score(rng: np.random.Generator, seconds: float,
               fam: dict) -> list:
    """The symbolic note sequence of a song: [(t, slot, [deg...],
    [dur...], [amp...])].  Split from the synthesis so COVER songs can
    replay a family's base score with perturbations (see make_song)."""
    n = int(SR * seconds)
    score = []
    t = 0
    while t < n:
        slot = int(SR * fam["beat"] * rng.uniform(0.85, 1.15))
        notes = rng.choice(36, size=rng.integers(1, 4), replace=False)
        durs = [int(slot * rng.uniform(1.0, 2.2)) for _ in notes]
        amps = [float(rng.uniform(0.25, 0.7)) for _ in notes]
        score.append((t, slot, list(notes), durs, amps))
        t += slot
    return score


def perturb_score(rng: np.random.Generator, score: list,
                  sub_prob: float, time_jitter: float) -> list:
    """A 'cover' of a score: each note independently substituted with
    probability sub_prob (random scale degree), onsets jittered by up to
    +-time_jitter seconds, amplitudes redrawn.  Low sub_prob leaves long
    stretches of the sequence identical across siblings — exactly the
    regime where 10 s alignment votes start confusing in-family songs
    (the eval-difficulty knob VERDICT r4 #3 asks for; real-music corpora
    get this confusability from covers/loops/shared samples)."""
    out = []
    for (t, slot, notes, durs, amps) in score:
        t2 = t + int(SR * rng.uniform(-time_jitter, time_jitter))
        notes2 = [int(rng.integers(0, 36)) if rng.random() < sub_prob
                  else d for d in notes]
        amps2 = [float(rng.uniform(0.25, 0.7)) for _ in notes]
        out.append((max(t2, 0), slot, notes2, list(durs), amps2))
    return out


def render_score(rng: np.random.Generator, seconds: float, fam: dict,
                 score: list) -> np.ndarray:
    n = int(SR * seconds)
    out = np.zeros(n + SR, dtype=np.float32)  # slack for note ring-out
    for (t, slot, notes, durs, amps) in score:
        if t >= n:
            continue
        for deg, dur, amp in zip(notes, durs, amps):
            dur = min(dur, out.shape[0] - t)
            out[t : t + dur] += amp * synth_note(
                fam, float(fam["scale"][deg]), dur, rng
            )
    out = out[:n]
    out += 0.015 * rng.standard_normal(n).astype(np.float32)
    return 0.6 * out / max(float(np.abs(out).max()), 1e-9)


def make_song(rng: np.random.Generator, seconds: float,
              fam: dict | None = None,
              score: list | None = None) -> np.ndarray:
    """A 'song' in a family: its own note/chord SEQUENCE over the shared
    scale/timbre/tempo.  The sequence is the fingerprint — alignment
    voting (NN engine and landmark histogram alike) must tell siblings
    apart through it.  Passing ``score`` renders that sequence instead
    (cover-version generation, see perturb_score)."""
    if fam is None:
        fam = make_family(rng)
    if score is None:
        score = make_score(rng, seconds, fam)
    return render_score(rng, seconds, fam, score)


def make_noise_clip(rng: np.random.Generator, kind: str, seconds: float
                    ) -> np.ndarray:
    n = int(SR * seconds)
    white = rng.standard_normal(n).astype(np.float32)
    if kind == "white":
        out = white
    elif kind == "babble":
        # overlapping notes from throwaway families = musical background
        # (the hardest noise class for both systems: it has real peaks)
        out = np.zeros(n, np.float32)
        for _ in range(6):
            fam = make_family(rng)
            start = int(rng.uniform(0, 0.7) * n)
            # round seconds UP: int(SR*s) in make_song may undershoot
            # n - start by one sample otherwise
            clip = make_song(rng, (n - start + 1) / SR + 1e-6, fam)
            m = min(n - start, clip.shape[0])
            out[start : start + m] += rng.uniform(0.3, 1.0) * clip[:m]
    elif kind == "bursts":
        # white-noise bursts on a random grid (transient noise —
        # specifically attacks the landmark's onset anchors)
        out = 0.05 * white
        t = 0
        while t < n:
            dur = int(SR * rng.uniform(0.02, 0.15))
            out[t : t + dur] += (rng.uniform(0.5, 1.0)
                                 * white[t : t + dur][::-1])
            t += dur + int(SR * rng.uniform(0.1, 0.8))
    elif kind == "sweep":
        # slow narrowband sweep (siren-like)
        tt = np.arange(n, dtype=np.float32) / SR
        f0, f1 = sorted(rng.uniform(200, 3000, 2))
        phase = 2 * np.pi * np.cumsum(
            f0 * (f1 / f0) ** (tt / tt[-1])
        ) / SR
        out = np.sin(phase).astype(np.float32) + 0.1 * white
    elif kind == "pink":
        spec = np.fft.rfft(white)
        f = np.maximum(np.fft.rfftfreq(n, 1 / SR), 1.0)
        out = np.fft.irfft(spec / np.sqrt(f), n).astype(np.float32)
    elif kind == "amband":
        spec = np.fft.rfft(white)
        f = np.fft.rfftfreq(n, 1 / SR)
        lo = rng.uniform(300, 1500)
        band = ((f > lo) & (f < lo * rng.uniform(1.5, 3.0))).astype(np.float32)
        carrier = np.fft.irfft(spec * band, n).astype(np.float32)
        am = 0.5 + 0.5 * np.sin(
            2 * np.pi * rng.uniform(0.3, 3.0) * np.arange(n) / SR
        ).astype(np.float32)
        out = carrier * am
    else:  # hum: mains fundamental + harmonics + a white floor
        f0 = rng.choice([50.0, 60.0])
        tt = np.arange(n, dtype=np.float32) / SR
        out = sum(
            rng.uniform(0.2, 1.0) / (k + 1)
            * np.sin(2 * np.pi * f0 * (k + 1) * tt + rng.uniform(0, 6.28))
            for k in range(6)
        ).astype(np.float32) + 0.1 * white
    return 0.5 * out / max(float(np.abs(out).max()), 1e-9)


def make_room_ir(rng: np.random.Generator, rt60: float) -> np.ndarray:
    n = int(SR * 0.8)
    h = np.zeros(n)
    h[0] = 1.0
    tail = rng.standard_normal(n) * np.exp(
        -3.0 * np.log(10) * np.arange(n) / (rt60 * SR)
    )
    h += rng.uniform(0.1, 0.4) * tail
    return h


def make_mic_ir(rng: np.random.Generator) -> np.ndarray:
    n = int(SR * 0.25)
    h = np.zeros(n, np.float32)
    h[0] = 1.0
    # a short colored tail = mic/speaker coloration
    k = int(SR * 0.01)
    h[1 : k + 1] = rng.uniform(-0.3, 0.3, k) * np.exp(-np.arange(k) / (0.002 * SR))
    return h


def write_csv(path: str, names: list[str]) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["file"])
        w.writerows([[n] for n in names])


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default="out/synth_dataset")
    ap.add_argument("--train-songs", type=int, default=60)
    ap.add_argument("--val-songs", type=int, default=10)
    ap.add_argument("--db-songs", type=int, default=100,
                    help="dummy DB tracks (never queried)")
    ap.add_argument("--test-songs", type=int, default=30,
                    help="in-DB tracks the queries are cut from")
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--family-size", type=int, default=8,
                    help="songs per family (shared scale/timbre/tempo); "
                    "db+test share one family pool so every test song "
                    "has in-DB siblings")
    ap.add_argument("--cover-frac", type=float, default=0.0,
                    help="fraction of db/test songs rendered as COVERS "
                    "of their family's base sequence (perturb_score) — "
                    "the eval-difficulty knob: covers share long "
                    "stretches of the note sequence, so alignment votes "
                    "start confusing siblings")
    ap.add_argument("--cover-sub", type=float, default=0.25,
                    help="per-note substitution probability of a cover")
    ap.add_argument("--cover-jitter", type=float, default=0.06,
                    help="cover onset jitter, seconds")
    ap.add_argument("--seed", type=int, default=3)  # fma_large.py:39
    args = ap.parse_args(None if argv is None else argv[1:])

    root = args.root
    for sub in ("music", "noise", "air", "micirp", "lists"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    rng = np.random.default_rng(args.seed)

    groups = {
        "train": args.train_songs,
        "val": args.val_songs,
        "db": args.db_songs,
        "test": args.test_songs,
    }
    # family pools: train/val each their own; db+test SHARED (test songs
    # must have in-DB siblings for segment-level confusability)
    fs = max(args.family_size, 1)
    pools = {
        "train": [make_family(rng)
                  for _ in range(-(-groups["train"] // fs))],
        "val": [make_family(rng) for _ in range(-(-groups["val"] // fs))],
    }
    pools["db"] = pools["test"] = [
        make_family(rng)
        for _ in range(-(-(groups["db"] + groups["test"]) // fs))
    ]
    names: dict[str, list[str]] = {}
    i = 0
    fam_at = {"train": 0, "val": 0, "db": 0}
    base_scores: dict[int, list] = {}  # db-pool family idx -> base score
    for group, count in groups.items():
        pool = pools[group]
        key = "db" if group in ("db", "test") else group
        names[group] = []
        for _ in range(count):
            name = "s%04d.wav" % i
            fam_idx = fam_at[key] % len(pool)
            fam = pool[fam_idx]
            fam_at[key] += 1
            score = None
            if key == "db" and args.cover_frac > 0:
                if fam_idx not in base_scores:
                    # the family's first song defines the base sequence
                    base_scores[fam_idx] = make_score(
                        rng, args.seconds, fam
                    )
                    score = base_scores[fam_idx]
                elif rng.random() < args.cover_frac:
                    score = perturb_score(
                        rng, base_scores[fam_idx],
                        args.cover_sub, args.cover_jitter,
                    )
            write_wav(
                os.path.join(root, "music", name),
                make_song(rng, args.seconds, fam, score=score), SR,
            )
            names[group].append(name)
            i += 1
    lists = os.path.join(root, "lists")
    write_csv(os.path.join(lists, "music_train.csv"), names["train"])
    write_csv(os.path.join(lists, "music_val.csv"), names["val"])
    write_csv(os.path.join(lists, "music_test.csv"), names["test"])
    with open(os.path.join(lists, "db.txt"), "w") as f:
        for name in names["db"] + names["test"]:
            f.write(os.path.join(root, "music", name) + "\n")

    kinds = ["white", "pink", "amband", "hum", "babble", "bursts", "sweep"]
    noise_names = []
    for j in range(28):
        name = "n%03d.wav" % j
        write_wav(
            os.path.join(root, "noise", name),
            make_noise_clip(rng, kinds[j % len(kinds)], 10.0), SR,
        )
        noise_names.append(name)
    write_csv(os.path.join(lists, "noise_train.csv"), noise_names[:21])
    write_csv(os.path.join(lists, "noise_val.csv"), noise_names[21:])

    import scipy.io

    air_names = []
    for j, rt60 in enumerate((0.12, 0.25, 0.4, 0.6)):
        name = "room%d.mat" % j
        scipy.io.savemat(
            os.path.join(root, "air", name),
            {
                "h_air": make_room_ir(rng, rt60)[None, :],
                "air_info": {"fs": np.array([[SR]]), "room": "room%d" % j},
            },
        )
        air_names.append(name)
    write_csv(os.path.join(lists, "air_train.csv"), air_names[:2])
    write_csv(os.path.join(lists, "air_val.csv"), air_names[2:])

    mic_names = []
    for j in range(3):
        name = "mic%d.wav" % j
        write_wav(os.path.join(root, "micirp", name), make_mic_ir(rng), SR)
        mic_names.append(name)
    write_csv(os.path.join(lists, "micirp_train.csv"), mic_names[:2])
    write_csv(os.path.join(lists, "micirp_val.csv"), mic_names[2:])

    total = sum(groups.values())
    print("synth corpus at %s: %d songs x %.0f s, %d noise clips, "
          "%d rooms, %d mics" % (root, total, args.seconds, len(noise_names),
                                 len(air_names), len(mic_names)))


if __name__ == "__main__":
    main()
