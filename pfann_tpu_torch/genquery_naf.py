"""Generate NAF-style test queries, on the port's host modules:
per-1-second-segment independent time offsets (the neural-audio-fp
evaluation protocol).

    python -m pfann_tpu_torch.genquery_naf -p configs/xxx.json -l 1 --num 2000 \
        --mode test -o outdir

Same argv, seeds (9000 + index) and output bytes as the JAX
``genquery_naf.py``: the whole file is cut into segment_size pieces, each
with an independent shift within ±(time_offset − segment) and its own
noise and IR draws (``data/querygen.py`` ``synthesize_query_naf``), numpy
on the host; no device is involved.
"""

import argparse
import os

import numpy as np

from pfann_tpu_torch.data.querygen import (
    QuerySetWriter,
    ReverbBank,
    confirm_overwrite,
    fft_block_len,
    load_eval_corpora,
    synthesize_query_naf,
)
from pfann_tpu_torch.utils.config import read_config, read_file_list


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-p", "--params", default="configs/default.json")
    ap.add_argument("-l", "--length", type=float, default=1)
    ap.add_argument("--num", type=int, default=10)
    ap.add_argument("--mode", default="test",
                    choices=["train", "validate", "test"])
    ap.add_argument("-o", "--out", required=True)
    ap.add_argument("--yes", action="store_true")
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
    snr_range = (params["noise"]["snr_min"], params["noise"]["snr_max"])
    music = read_file_list(params[args.mode + "_csv"])
    music_dir = params["music_dir"]

    writer = QuerySetWriter(args.out, params["sample_rate"])
    for i in range(args.num):
        rng = np.random.default_rng(9000 + i)
        source = music[i % len(music)]
        audio = synthesize_query_naf(
            rng, os.path.join(music_dir, source), params, noise, reverb, snr_range,
        )
        # NAF protocol: whole-file queries, so ground-truth time is 0
        writer.add(i, source, audio, 0.0, float("nan"), "")
    params["genquery"] = {"mode": args.mode, "length": args.length, "naf": True}
    writer.close(params)


if __name__ == "__main__":
    main()
