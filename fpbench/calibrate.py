"""Readings that a cell's limits are set from: the program's and the
control's ``answer_err`` on many seeds, in one process.

    python3 -m fpbench.calibrate --workload <name> --seeds 11,12,13 --seconds 5

For each seed it makes one run of the cell at the cell's own sizes and load
(a short window), compares the program's answers with the reference as a
benchmark run does, then puts the control (the reference at fp8) in the
program's place on the same queries and judges it by the same ``correct``,
which has to come out false.  One JSON line a seed.  The benchmark's own
runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from fpbench import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fpbench.calibrate: no CUDA card visible", file=sys.stderr)
        return 2
    cell = run.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        out = run.run_cell(cell, seed, args.seconds, False, torch.device("cuda", 0),
                           time.time(), control=True)
        info = out["info"]
        print(json.dumps({
            "workload": args.workload, "seed": seed, "correct": out["correct"],
            "answer_err": out["checks"]["answer_err"]["value"],
            "control_correct": info["control"]["correct"],
            "components": info["components"], "control": info["control"],
            "checked": info["checked"], "hit_share": info["hit_share"],
            "escalated": info["escalated"], "batches": info["batches"],
            "attempted": out["attempted"],
            "failed": out["failed"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
