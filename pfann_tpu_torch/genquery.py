"""Generate noisy/reverberant test queries and their ground truth, on the
port's host modules.

    python -m pfann_tpu_torch.genquery -p configs/xxx.json -l 10 --num 2000 \
        --mode test -o outdir

Same argv, seeds (9000 + index) and output bytes as the JAX
``genquery.py``: the synthesis is ``data/querygen.py`` (crop with context,
noise at a uniform SNR, room x mic reverb, inf-norm), numpy on the host;
no device is involved.
"""

import argparse
import os

import numpy as np

from pfann_tpu_torch.data.querygen import (
    ClipSampler,
    QuerySetWriter,
    ReverbBank,
    confirm_overwrite,
    fft_block_len,
    load_eval_corpora,
    synthesize_query,
)
from pfann_tpu_torch.utils.config import read_config, read_file_list


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-p", "--params", default="configs/default.json")
    ap.add_argument("-l", "--length", type=float, default=1,
                    help="query length in seconds")
    ap.add_argument("--num", type=int, default=10)
    ap.add_argument("--mode", default="test",
                    choices=["train", "validate", "test"])
    ap.add_argument("-o", "--out", required=True)
    ap.add_argument("--yes", action="store_true",
                    help="overwrite without asking")
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> None:
    args = parse_args(None if argv is None else argv[1:])
    if not confirm_overwrite(args.out, args.yes):
        return

    params = read_config(args.params)
    split = "validate" if args.mode == "test" else args.mode
    params["fftconv_n"] = fft_block_len(params, args.length)
    noise, air, micirp = load_eval_corpora(params, split, params["fftconv_n"])
    reverb = ReverbBank(air, micirp, params["fftconv_n"])
    sampler = ClipSampler(params["sample_rate"], args.length, params["pad_start"])
    snr_range = (params["noise"]["snr_min"], params["noise"]["snr_max"])
    music = read_file_list(params[args.mode + "_csv"])
    music_dir = params["music_dir"]

    writer = QuerySetWriter(args.out, params["sample_rate"])
    for i in range(args.num):
        rng = np.random.default_rng(9000 + i)
        source = music[i % len(music)]
        audio, t0, snr, room = synthesize_query(
            rng, os.path.join(music_dir, source), sampler, noise, reverb, snr_range,
        )
        writer.add(i, source, audio, t0, snr, room)
    params["genquery"] = {"mode": args.mode, "length": args.length}
    writer.close(params)


if __name__ == "__main__":
    main()
