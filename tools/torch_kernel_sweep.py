"""Time the port's align-reduce kernel across tile-plan variants on one card.

    python tools/torch_kernel_sweep.py [--out FILE.json] [--reps N]
                                       [--only SUBSTRING[,SUBSTRING...]]

A development tool of pfann_tpu_torch, kept outside the package: it swaps
``align_kernel.tile_plan`` for a plan with some fields overridden while it
times a variant, and restores it after.

Shapes: the exhaustive engine of chip_smoke.py phase 4 (10,000 songs,
R = 152, bf16, d = 128, S = 19, B = 1024 and 32), the screened engine's
stage 1 of phase 6 (100,000 songs, Rc = 40, int8, Sc = 5, B = 1024) and
its stage 3 (100,000 songs, R = 160, bf16, S = 19, B = 256); phase 4 and
stage 1 also at R = 128, where no warp's rows straddle two songs.  In f32
(``db_dtype: float32``): phase 3's shapes (1,000 songs; R = 152, S = 19,
B = 1, 100 and 1024; R = 248, S = 119, B = 1024), f1 (phase 4's corpus
at B = 1024 and 32, S = 24: the Database pads 19-row queries to 24
windows; also at S = 19), f2 (the f32 stage 1: Rc = 40, Sc = 5,
B = 1024) and f3 (the f32 stage 3: R = 160, B = 256).
Variants override the plan's A stages (abuf), songs per block (G) and
query tile (tn: the plan for a batch of that many queries).  Every
variant's outputs are held to the default plan's (int8 bitwise, bf16 and
f32 within 2e-3) before it is timed.  ``--only`` keeps the shapes whose
name holds one of the comma-separated substrings and times their default
plan alone, ``tile_plan`` untouched: the quick before/after of two trees.
Data are random, made on the card from a seed.  Prints one line per
(shape, variant) with the card's name and power limit, and writes them as
JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pfann_tpu_torch.index import align_kernel  # noqa: E402
from pfann_tpu_torch.index.align_kernel import align_reduce  # noqa: E402

SHAPES = [  # name, dtype, n_songs, R, S, B
    ("phase4 bf16 B=1024", torch.bfloat16, 10_000, 152, 19, 1024),
    ("phase4 bf16 B=1024 R=128", torch.bfloat16, 10_000, 128, 19, 1024),
    ("phase4 bf16 B=32", torch.bfloat16, 10_000, 152, 19, 32),
    ("stage3 bf16 B=256", torch.bfloat16, 100_000, 160, 19, 256),
    ("stage1 int8 B=1024", torch.int8, 100_000, 40, 5, 1024),
    ("stage1 int8 B=1024 R=128", torch.int8, 31_250, 128, 5, 1024),
    ("phase3 f32 B=1", torch.float32, 1_000, 152, 19, 1),
    ("phase3 f32 B=100", torch.float32, 1_000, 152, 19, 100),
    ("phase3 f32 B=1024", torch.float32, 1_000, 152, 19, 1024),
    ("phase3 f32 S=119 B=1024", torch.float32, 1_000, 248, 119, 1024),
    ("f1 f32 B=1024", torch.float32, 10_000, 152, 24, 1024),
    ("f1 f32 B=32", torch.float32, 10_000, 152, 24, 32),
    ("f1 f32 B=1024 S=19", torch.float32, 10_000, 152, 19, 1024),
    ("f2 f32 stage1 B=1024", torch.float32, 100_000, 40, 5, 1024),
    ("f3 f32 stage3 B=256", torch.float32, 100_000, 160, 19, 256),
]
# {"G": 1} goes last: the variant timed right after it read up to 15%
# slow even where its plan equals the default one
VARIANTS = [{}, {"abuf": 2}, {"abuf": 1}, {"tn": 32}, {"G": 1}]
# f32 at d = 128 never fits two A stages in its 256-row subtiles
F32_VARIANTS = [{}, {"tn": 32}, {"G": 5}, {"G": 2}, {"G": 1}]


def _time_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _with(over):
    """tile_plan with some fields overridden (shared memory recomputed); a
    query tile is overridden by the plan for a batch of that many queries."""
    base = align_kernel.tile_plan

    def plan(B, S, d, itemsize, R, n_songs):
        p = dict(base(min(B, over.get("tn", B)), S, d, itemsize, R, n_songs))
        p.update((k, v) for k, v in over.items() if k != "tn")
        p["smem"] = align_kernel.smem_bytes(d, itemsize, p["tm"], p["tn"], p["G"], p["sc"],
                                            p["abuf"])
        p["grid"] = (-(-n_songs // p["G"]), -(-B // p["tn"]))
        return p if p["smem"] <= align_kernel.SMEM_LIMIT else None

    return plan


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--only", default="",
                    help="comma-separated substrings: time the default plan of the "
                         "shapes whose name holds one")
    args = ap.parse_args(argv)
    only = [x for x in args.only.split(",") if x]
    if not torch.cuda.is_available():
        raise SystemExit("kernel_sweep: no CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows, base_plan = [], align_kernel.tile_plan
    d = 128
    for name, dtype, n_songs, R, S, B in SHAPES:
        if only and not any(x in name for x in only):
            continue
        N = n_songs * R
        if dtype == torch.int8:
            db = torch.randint(-127, 128, (N, d), generator=gen, device=dev,
                               dtype=torch.int8)
            q = torch.randint(-127, 128, (B, S, d), generator=gen, device=dev,
                              dtype=torch.int8)
        else:
            db = (torch.randn(N, d, generator=gen, device=dev) / d**0.5).to(dtype)
            q = (torch.randn(B, S, d, generator=gen, device=dev) / d**0.5).to(dtype)
        want = None
        variants = F32_VARIANTS if dtype == torch.float32 else VARIANTS
        for over in variants[:1] if only else variants:
            plan = None
            if not only:
                plan_fn = _with(over)
                plan = plan_fn(B, S, d, db.element_size(), R, n_songs)
                if plan is None:
                    continue
                align_kernel.tile_plan = lambda *a, f=plan_fn: f(*a)
            try:
                got = align_reduce(db, q, R, S, n_songs)
                if want is None:
                    want = got
                elif dtype == torch.int8:
                    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
                else:
                    assert float((got[0] - want[0]).abs().max()) <= 2e-3
                ms = _time_ms(lambda: align_reduce(db, q, R, S, n_songs), args.reps)
            finally:
                align_kernel.tile_plan = base_plan
            row = dict(shape=name, variant=over or "plan", ms=ms,
                       plan=plan and {k: plan[k] for k in ("tn", "tm", "rowsum", "G", "sc",
                                                           "abuf", "smem")},
                       tops=2.0 * N * d * S * B / ms / 1e9, card=card)
            rows.append(row)
            print("%-26s %-14s %9.3f ms  %7.1f T(FL)OP/s  %s  [%s]" % (
                name, json.dumps(over) if over else "plan", ms, row["tops"],
                row["plan"], card), flush=True)
        del db, q, want
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
