"""Time the port's align-reduce kernel across tile-plan variants on one card.

    python tools/torch_kernel_sweep.py [--out FILE.json] [--reps N]
                                       [--only SUBSTRING[,SUBSTRING...]]
                                       [--shapes SUBSTRING[,...]]
                                       [--root DIR] [--compare DIR]
    python tools/torch_kernel_sweep.py --norm-act [--out FILE.json] [--reps N]

A development tool of pfann_tpu_torch, kept outside the package: it swaps
``align_kernel.tile_plan`` for a plan with some fields overridden while it
times a variant, and restores it after.

Shapes (d = 128 unless named): the exhaustive engine of chip_smoke.py
phase 4 (10,000 songs, R = 152, bf16, S = 19, B = 1024 and 32), the
screened engine's stage 1 of phase 6 (100,000 songs, Rc = 40, int8,
Sc = 5, B = 1024) and its stage 3 (100,000 songs, R = 160, bf16, S = 19,
B = 256); the benchmark's d = 64 screen over 100,000 songs (fpbench cell
d64-100k-emb-noisy): stage 3 on its ~51 escalated queries (R = 160,
S = 24 as the bucketed filters had it, S = 19 as the top-1 path launches)
and stage 1 on a batch of 256 (Rc = 40, Sc = 6 and 5).  In f32
(``db_dtype: float32``): phase 3's shapes (1,000 songs; R = 152, S = 19,
B = 1, 100 and 1024; R = 248, S = 119, B = 1024), f1 (phase 4's corpus
at B = 1024 and 32, S = 24: the Database pads 19-row queries to 24
windows; also at S = 19), f2 (the f32 stage 1: Rc = 40, Sc = 5,
B = 1024) and f3 (the f32 stage 3: R = 160, B = 256).

Variants of the bf16/int8 (wgmma) plan override its query tile (tn), its
query-row ring (qs: 2, 4 or 8 stages streaming; S holds the tile
resident) and its instantiation (config: rowsum, consumer warpgroups,
m64 tiles a warpgroup, i.e. rows a warpgroup / 64, and ping-pong
accumulators, the epilogue overlapping the next subtile's products, or
not); f32 variants its query tile and songs per block.  Every variant's
outputs are held to the default plan's (int8 bitwise, bf16 and f32 within
2e-3) before it is timed.  ``--only`` keeps the shapes whose name holds
one of the comma-separated substrings and times their default plan alone;
``--shapes`` keeps them with every variant.
``--root DIR`` times the package of another tree (unpacked from git into
a directory that .gitignore lists), whatever its tile plan.  ``--compare
DIR`` is the before/after of two trees in one call: the default plans of
phase 4 (B = 1024 and 32), stage 1 and stage 3 from DIR, from this tree,
from this tree and from DIR again, each in a process of its own.  Data
are random, made on the card from a seed.  Prints one line per (shape,
variant) with the card's name and power limit, the launch's bound (the
larger of its operations at the dtype's dense peak and its bytes, the
layout and queries in and the per-song outputs out, at HBM3's) and the
share of it the time reaches, and writes them as JSON.

``--norm-act`` times FpNetwork's norm-and-activation kernel
(``models/norm_act.py``) instead: at the audio batch's 16 norm volumes
(4,864 segments of the d = 128 encoder, bf16, ReLU after the norm), every
form and tile the source builds (each rows tile whose block holds the
segment with no thread idle, and the split form), each held to the plan's
output (one bf16 ulp, or 1e-5 near 0) before it is timed, beside the
kernel's bound (4 bytes an element and the affine once, at HBM3's rate);
the plan's own form is marked.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMPARED = "phase4 bf16 B=1024,phase4 bf16 B=32,stage1 int8,stage3 bf16"


def _import(root):
    sys.path.insert(0, os.path.abspath(root))
    import torch  # noqa: F401

    import pfann_tpu_torch.index.align_kernel as align_kernel

    if not align_kernel.__file__.startswith(os.path.abspath(root)):
        raise SystemExit("kernel_sweep: imported %s, not from %s" % (align_kernel.__file__, root))
    return align_kernel


SHAPES = [  # name, dtype, n_songs, R, S, B, d
    ("phase4 bf16 B=1024", "bfloat16", 10_000, 152, 19, 1024, 128),
    ("phase4 bf16 B=32", "bfloat16", 10_000, 152, 19, 32, 128),
    ("stage3 bf16 B=256", "bfloat16", 100_000, 160, 19, 256, 128),
    ("stage1 int8 B=1024", "int8", 100_000, 40, 5, 1024, 128),
    ("stage3 bf16 d=64 B=51 S=24", "bfloat16", 100_000, 160, 24, 51, 64),
    ("stage3 bf16 d=64 B=51 S=19", "bfloat16", 100_000, 160, 19, 51, 64),
    ("stage1 bf16 d=64 B=256 Sc=6", "bfloat16", 100_000, 40, 6, 256, 64),
    ("stage1 bf16 d=64 B=256 Sc=5", "bfloat16", 100_000, 40, 5, 256, 64),
    ("phase3 f32 B=1", "float32", 1_000, 152, 19, 1, 128),
    ("phase3 f32 B=100", "float32", 1_000, 152, 19, 100, 128),
    ("phase3 f32 B=1024", "float32", 1_000, 152, 19, 1024, 128),
    ("phase3 f32 S=119 B=1024", "float32", 1_000, 248, 119, 1024, 128),
    ("f1 f32 B=1024", "float32", 10_000, 152, 24, 1024, 128),
    ("f1 f32 B=32", "float32", 10_000, 152, 24, 32, 128),
    ("f1 f32 B=1024 S=19", "float32", 10_000, 152, 19, 1024, 128),
    ("f2 f32 stage1 B=1024", "float32", 100_000, 40, 5, 1024, 128),
    ("f3 f32 stage3 B=256", "float32", 100_000, 160, 19, 256, 128),
]
# dense peaks of one H100 SXM (NVIDIA's data sheet): bf16 and int8 on the
# tensor cores, f32 FFMA on the CUDA cores; bytes a second of HBM3
PEAK_OPS = {"bfloat16": 989e12, "int8": 1979e12, "float32": 67e12}
HBM_BYTES_S = 3.35e12
# bf16/int8: overrides of wgmma_plan (config = (rowsum, NWG, MT, ping-pong,
# blocks per SM))
VARIANTS = {
    "bfloat16": [{}, {"qs": 2}, {"qs": 4}, {"tn": 32}, {"tn": 64}, {"tn": 128},
                 {"config": (False, 2, 1, True, 1), "tn": 64},
                 {"config": (True, 2, 1, False, 1)}],
    "int8": [{}, {"tn": 32}, {"qs": 4}, {"config": (False, 2, 1, True, 1)},
             {"config": (False, 2, 1, False, 1), "tn": 128},
             {"config": (False, 1, 1, False, 2), "tn": 64}],
}
# f32 at d = 128 never fits two A stages in its 256-row subtiles
F32_VARIANTS = [{}, {"tn": 32}, {"G": 5}, {"G": 2}, {"G": 1}]


def bound_ms(dtype: str, itemsize: int, n_songs: int, R: int, S: int, B: int,
             d: int) -> float:
    """The least time of one launch: its operations (2 x S x d x B a layout
    row) at the dtype's peak, or its bytes (the layout and the queries
    read once, best and argoff written) at HBM3's rate, whichever is
    longer."""
    N = n_songs * R
    ops = 2.0 * N * d * S * B
    nbytes = (N + B * S) * d * itemsize + B * n_songs * 8
    return 1e3 * max(ops / PEAK_OPS[dtype], nbytes / HBM_BYTES_S)


def _time_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _with(ak, over):
    """tile_plan with some fields overridden; None where it does not fit
    or the kernel has no such instantiation."""
    base = ak.tile_plan

    def f32_plan(B, S, d, itemsize, R, n_songs):
        p = dict(base(min(B, over.get("tn", B)), S, d, itemsize, R, n_songs))
        p.update((k, v) for k, v in over.items() if k != "tn")
        p["smem"] = ak.smem_bytes(d, itemsize, p["tm"], p["tn"], p["G"], p["sc"], p["abuf"])
        p["grid"] = (-(-n_songs // p["G"]), -(-B // p["tn"]))
        return p if p["smem"] <= ak.SMEM_LIMIT else None

    def wgmma_plan(B, S, d, itemsize, R, n_songs):
        qs = over.get("qs")
        try:
            p = ak.wgmma_plan(B, S, d, itemsize, R, n_songs, config=over.get("config"),
                              tn=over.get("tn"), qs=S if qs == "S" else qs)
        except ValueError:
            return None
        key = (itemsize, p["rowsum"], p["nwg"], p["mt"], p["pp"], p["bps"], p["tn"])
        return p if key in ak.WGMMA_BUILT else None

    return lambda B, S, d, itemsize, *a: (
        f32_plan if itemsize == 4 else wgmma_plan)(B, S, d, itemsize, *a)


def run(args) -> list:
    ak = _import(args.root)
    import torch

    only = [x for x in args.only.split(",") if x]
    shapes = [x for x in args.shapes.split(",") if x] or only
    if not torch.cuda.is_available():
        raise SystemExit("kernel_sweep: no CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows, base_plan = [], ak.tile_plan
    for name, dt, n_songs, R, S, B, d in SHAPES:
        if shapes and not any(x in name for x in shapes):
            continue
        dtype = getattr(torch, dt)
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
        variants = F32_VARIANTS if dtype == torch.float32 else VARIANTS[dt]
        for over in variants[:1] if only else variants:
            plan = None
            if not only:
                plan_fn = _with(ak, over)
                plan = plan_fn(B, S, d, db.element_size(), R, n_songs)
                if plan is None:
                    continue
                ak.tile_plan = lambda *a, f=plan_fn: f(*a)
            try:
                got = ak.align_reduce(db, q, R, S, n_songs)
                if want is None:
                    want = got
                elif dtype == torch.int8:
                    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
                else:
                    assert float((got[0] - want[0]).abs().max()) <= 2e-3
                ms = _time_ms(torch, lambda: ak.align_reduce(db, q, R, S, n_songs), args.reps)
            finally:
                ak.tile_plan = base_plan
            shown = plan and {k: v for k, v in plan.items() if k not in ("grid", "threads")}
            bound = bound_ms(dt, db.element_size(), n_songs, R, S, B, d)
            row = dict(shape=name, d=d, variant=over or "plan", ms=ms, plan=shown,
                       root=args.root, tops=2.0 * N * d * S * B / ms / 1e9, bound_ms=bound,
                       share=bound / ms, card=card)
            rows.append(row)
            print("%-28s %-34s %9.3f ms  %7.1f T(FL)OP/s  bound %.4f ms (%.1f%%)  %s  %s  [%s]"
                  % (name, json.dumps(over) if over else "plan", ms, row["tops"], bound,
                     100.0 * bound / ms, args.root, shown or "", card), flush=True)
        del db, q, want
        torch.cuda.empty_cache()
    return rows


def run_norm_act(args, n=4864) -> list:
    sys.path.insert(0, HERE)
    import torch

    from pfann_tpu_torch.models import norm_act as na
    from pfann_tpu_torch.models.fp_network import build_fp_network

    if not torch.cuda.is_available():
        raise SystemExit("kernel_sweep: no CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    cfg = {"sample_rate": 8000, "stft_hop": 256, "n_mels": 256, "segment_size": 1,
           "model": {"d": 128, "h": 1024, "u": 32, "fuller": True}}
    shapes = [ln.shape for blk in build_fp_network(cfg).f.blocks for ln in (blk.ln1, blk.ln2)]
    rows = []
    for shape in shapes:
        V = int(torch.Size(shape).numel())
        w = 1 + 0.2 * torch.randn(shape, generator=gen, device=dev)
        b = 0.1 * torch.randn(shape, generator=gen, device=dev)
        x = torch.randn((n, *shape), generator=gen, device=dev, dtype=torch.bfloat16)
        nv, chosen = V // 8, na.plan(V, 2)
        forms = [dict(form="rows", vpt=vpt, G=max(32, na._pow2(-(-nv // vpt))), segs=segs)
                 for vpt, segs in na.ROWS_TILES]
        forms = [p for p in forms if p["G"] <= na.THREADS
                 and (p["G"] == 32 or (p["G"] // 2) * p["vpt"] < nv)] + [dict(form="split")]
        want = na.norm_act(x.clone(), w, b, 1e-5, "ReLU", True).float()
        ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(2.0 ** -126))) - 7)
        tol = ulp.clamp_min_(1e-5)
        del ulp
        y = x.clone()
        bound = (n * V * 4 + V * 8) / HBM_BYTES_S * 1e3
        for p in forms:
            y.copy_(x)
            na._launch(y, w, b, 1e-5, "ReLU", True, p)
            assert bool(((y.float() - want).abs() <= tol).all()), (shape, p)
            ms = _time_ms(torch, lambda: na._launch(y, w, b, 1e-5, "ReLU", True, p), args.reps)
            row = dict(shape=list(shape), V=V, form=p, plan=p == chosen, ms=ms, bound_ms=bound,
                       share=bound / ms, card=card)
            rows.append(row)
            print("%-16s V %7d  %-52s %8.3f ms  bound %.3f ms (%.1f%%)%s  [%s]" % (
                tuple(shape), V, json.dumps(p), ms, bound, 100.0 * bound / ms,
                "  plan" if row["plan"] else "", card), flush=True)
        del x, y, want, tol
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--only", default="",
                    help="comma-separated substrings: time the default plan of the "
                         "shapes whose name holds one")
    ap.add_argument("--shapes", default="",
                    help="comma-separated substrings: the shapes to time, every variant")
    ap.add_argument("--root", default=HERE, help="the tree whose package is timed")
    ap.add_argument("--compare", default=None,
                    help="another tree: its default plans against this tree's, "
                         "other, this, this, other")
    ap.add_argument("--norm-act", action="store_true",
                    help="time the norm-and-activation kernel's forms instead")
    args = ap.parse_args(argv)
    if args.norm_act:
        rows = run_norm_act(args)
    elif args.compare:
        rows = []
        for root in (args.compare, HERE, HERE, args.compare):
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--root", root, "--only",
                 args.only or COMPARED, "--reps", str(args.reps), "--out", "/dev/stdout"],
                capture_output=True, text=True, check=True).stdout
            lines = out.splitlines()
            print("\n".join(lines[: lines.index("[")] if "[" in lines else lines), flush=True)
            rows += json.loads("\n".join(lines[lines.index("["):]))
    else:
        rows = run(args)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
