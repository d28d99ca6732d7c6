"""Build a (music, noise, mix) triplet dataset for training a denoiser.

Parity: reference denoise/createdataset.py:27-188 — for each track: crop
``length`` seconds (+pad_start context), mono+resample, de-mean, pick a
noise crop scaled to a random SNR (or gaussian noise when no corpus),
apply the SAME room+mic IRs to music and noise separately, crop, mix,
joint peak-normalize, write music/ mix/ noise/ WAVs + per-split CSV.

The crop geometry and IR machinery are shared with the query generators
via :mod:`pfann_tpu_torch.data.querygen` (ClipSampler / ReverbBank — one IR
draw applied to two signals).

    python -m pfann_tpu_torch.tools.createdataset -d <music_dir> --noise <dir> --air <dir>
        --micirp <dir> -p configs/default.json -l 30 -o <out>

A copy of the JAX ``denoise/createdataset.py`` over the port's host
modules: the same seeds (5000 + index) write the same bytes.
"""

import argparse
import csv
import os

import numpy as np

from pfann_tpu_torch.audio.io import write_wav
from pfann_tpu_torch.data.querygen import (
    ClipSampler,
    ReverbBank,
    fft_block_len,
    load_eval_corpora,
)
from pfann_tpu_torch.utils.config import read_config


def make_triplet(rng, path, noise_data, reverb, sampler, params):
    """(music, noise, mix) at the pipeline rate, jointly peak-normalized.
    One reverb draw is applied to music and noise separately so the mix
    is physically consistent (createdataset.py:61-104 semantics)."""
    music, _ = sampler.sample(rng, path)
    music = music - music.mean()
    rms = float(np.sqrt((music**2).mean()))
    snr = rng.uniform(params["noise"]["snr_min"], params["noise"]["snr_max"])
    gain = rms * 10 ** (-0.05 * snr)
    if noise_data is not None:
        noise = noise_data.random_choose(rng, 1, music.shape[0])[0]
        noise_rms = float(np.sqrt((noise**2).mean()))
        noise = noise * (gain / max(noise_rms, 1e-12))
    else:
        noise = rng.normal(0.0, gain, music.shape[0]).astype(np.float32)

    mult, _ = reverb.draw(rng)
    keep = (sampler.n_ctx, sampler.n_ctx + sampler.n_clip)
    music_r = reverb.apply(music, mult, keep)
    noise_r = reverb.apply(noise, mult, keep)
    mix = music_r + noise_r

    vol = max(
        np.abs(mix).max(), np.abs(music_r).max(), np.abs(noise_r).max(), 1e-12
    )
    return music_r / vol, noise_r / vol, mix / vol


def gen_for(train_val, args, params):
    sample_rate = params["sample_rate"]
    # corpora come from the CLI flags only (an omitted flag disables the
    # member rather than falling back to the config's dataset dirs)
    noise, air, micirp = load_eval_corpora(
        params, train_val, params["fftconv_n"],
        noise_dir=args.noise or "", air_dir=args.air or "",
        mic_dir=args.micirp or "",
    )
    reverb = ReverbBank(air, micirp, params["fftconv_n"])
    sampler = ClipSampler(sample_rate, args.length, params["pad_start"])

    with open(params[train_val + "_csv"], "r") as fin:
        reader = csv.reader(fin)
        next(reader)
        music_list = [row[0] for row in reader]

    os.makedirs(args.out, exist_ok=True)
    for sub in ("music", "mix", "noise"):
        os.makedirs(os.path.join(args.out, sub), exist_ok=True)
    with open(
        os.path.join(args.out, "denoise_" + train_val + ".csv"),
        "w", encoding="utf8", newline="\n",
    ) as fout:
        writer = csv.writer(fout)
        writer.writerow(["mix_path", "music_path", "noise_path", "duration"])
        for i, name in enumerate(music_list):
            rng = np.random.default_rng(5000 + i)
            music, noise_out, mix = make_triplet(
                rng, os.path.join(args.data, name), noise, reverb, sampler,
                params,
            )
            base = os.path.splitext(os.path.split(name)[1])[0] + ".wav"
            # the reference writes the music path under the mix_path
            # column and vice versa (createdataset.py:151,158); here rows
            # follow the header
            writer.writerow(
                ["mix/" + base, "music/" + base, "noise/" + base,
                 float(args.length)]
            )
            write_wav(os.path.join(args.out, "music", base), music, sample_rate)
            write_wav(os.path.join(args.out, "mix", base), mix, sample_rate)
            write_wav(os.path.join(args.out, "noise", base), noise_out,
                      sample_rate)


def main(argv: list[str] | None = None) -> None:
    args = argparse.ArgumentParser()
    args.add_argument("-d", "--data", required=True)
    args.add_argument("--noise")
    args.add_argument("--air")
    args.add_argument("--micirp")
    args.add_argument("-p", "--params", default="configs/default.json")
    args.add_argument("-l", "--length", type=float, default=30)
    args.add_argument("-o", "--out", required=True)
    args = args.parse_args(None if argv is None else argv[1:])

    params = read_config(args.params)
    params["fftconv_n"] = fft_block_len(params, args.length)
    gen_for("train", args, params)
    gen_for("validate", args, params)


if __name__ == "__main__":
    main()
