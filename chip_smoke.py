#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pfann_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits nonzero:

  1. the card: nvidia-smi name and power limit, torch and CUDA versions.
     No CUDA, no run.
  2. build the align-reduce kernel from pfann_tpu_torch/csrc/ with nvcc.
  3. kernel against its plain PyTorch version on the card: bf16 and f32;
     pad 32 with S in {19, 24, 32} and pad 128 with S = 119; B in
     {1, 100, 1024}; ~1k songs of 40-120 rows at d = 128.  Then the int8
     variant against its plain version, bitwise: the same corpus pooled
     and quantized as the screened engine's stage 1 sees it (k = 4),
     Sc in {5, 6, 8, 30}, B in {1, 100, 1024}.
  4. the serving scenario of bench.py: 10,000 songs x 120 rows, d = 128,
     bf16, S = 19, 1,024 noisy self-queries; recall must be 1024/1024.
     Times the kernel against the plain version at B = 1024 and at the
     matcher's default batch of 32.
  5. the slice through the entry points: a 64-song x 30 s synthetic
     corpus, a flagship-width model (configs/default.json: d=128, h=1024,
     u=32, fuller) with random weights from a seed, saved with the port's
     writer; pfann_tpu_torch.builder, then pfann_tpu_torch.matcher in
     default and --top1 mode on 16 hop-aligned 10 s crops.  Then the same
     DB served by the screened engine (configs.json indexer screen: true,
     int8 stage 1, top 64 of 64 songs): both TSVs must equal the align
     engine's byte for byte.
  6. the screened engine at bench.py --scale 100000: 100,000 songs x 120
     rows, d = 128, k = 4, top_m = 32, bf16 exact layout, int8 stage 1,
     rescue 0.4.  1,024 clean queries (recall 1024/1024), 256 noisy ones
     (some escalate; answers equal the exhaustive engine's where its top-1
     margin is clear), the int8 kernel against its plain version on the
     coarse copy, and the same corpus with an int8 exact layout.

Each path (phase 5's two engines, phase 6's batches) is driven with the
kernel's launch counts set to 0 just before it and read just after.  The
line before the last is a JSON object describing each kernel; the last
line is {"ok": true, "device": {...}}.
"""

import csv
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# JAX-free host modules of pfann_tpu that the port reuses as they are
# (the port's builder imports them too); no JAX is imported here
from pfann_tpu.audio.io import write_wav  # noqa: E402
from pfann_tpu.data.musicdata import MusicDataset  # noqa: E402
from pfann_tpu_torch import builder, matcher  # noqa: E402
from pfann_tpu_torch.index import align_kernel  # noqa: E402
from pfann_tpu_torch.index.align import (  # noqa: E402
    AlignmentEngine,
    _top1,
    build_uniform_layout,
)
from pfann_tpu_torch.index.align_kernel import (  # noqa: E402
    align_reduce,
    align_reduce_reference,
    reset_launch_counts,
)
from pfann_tpu_torch.index.database import Database  # noqa: E402
from pfann_tpu_torch.index.embedder import Embedder  # noqa: E402
from pfann_tpu_torch.index.screen import (  # noqa: E402
    ScreenedAlignmentEngine,
    build_screen_layout,
    collapse_queries,
    quantize_coarse_int8,
    quantize_queries_int8,
)
from pfann_tpu_torch.models.fp_network import build_fp_network  # noqa: E402
from pfann_tpu_torch.utils.checkpoint import save_model  # noqa: E402

REPO = os.path.dirname(os.path.abspath(__file__))
# best may differ from the plain version's by f32 rounding of S*d-term sums
# taken in other orders; offsets may differ only where two offsets score
# within this of each other
BEST_ATOL = 2e-3


def phase(n, title):
    print("== phase %d: %s" % (n, title), flush=True)


def time_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def exact_scores(db_np, q_np, R, S, picks):
    """float64 align at (b, song, offset) triples, from the definition."""
    out = []
    for b, s, o in picks:
        rows = db_np[s * R + o : s * R + o + S].astype(np.float64)
        rows = np.concatenate([rows, np.zeros((S - len(rows), rows.shape[1]))])
        out.append(float((rows * q_np[b].astype(np.float64)).sum()))
    return np.asarray(out)


def compare(db, q, R, S, n_songs):
    """Kernel vs plain version on the same card tensors.  Returns
    (max |best diff|, #argoff differences, kernel outputs)."""
    kb, ko = align_reduce(db, q, R, S, n_songs)
    pb, po = align_reduce_reference(db, q, R, S, n_songs)
    torch.cuda.synchronize()
    kb, ko, pb, po = (t.cpu().numpy() for t in (kb, ko, pb, po))
    if not np.isfinite(kb).all():
        raise AssertionError("kernel best has non-finite values")
    err = float(np.abs(kb - pb).max()) if kb.size else 0.0
    if err > BEST_ATOL:
        raise AssertionError("kernel best off by %g > %g" % (err, BEST_ATOL))
    bad = np.argwhere(ko != po)
    if len(bad):
        if len(bad) > max(10, ko.size // 100):
            raise AssertionError("%d argoff differences" % len(bad))
        db_np = db.float().cpu().numpy()
        q_np = q.float().cpu().numpy()
        a = exact_scores(db_np, q_np, R, S, [(b, s, ko[b, s]) for b, s in bad])
        p = exact_scores(db_np, q_np, R, S, [(b, s, po[b, s]) for b, s in bad])
        if np.abs(a - p).max() > BEST_ATOL:
            raise AssertionError("argoff differs where the margin exceeds %g" % BEST_ATOL)
    return err, len(bad), (kb, ko)


def compare_exact(db, q, R, S, n_songs):
    """int8 kernel vs plain version on the same card tensors: best and
    argoff must be bitwise equal (both sums are exact).  Returns max
    |best diff| (0.0)."""
    kb, ko = align_reduce(db, q, R, S, n_songs)
    pb, po = align_reduce_reference(db, q, R, S, n_songs)
    torch.cuda.synchronize()
    err = float((kb - pb).abs().max()) if kb.numel() else 0.0
    if not (torch.equal(kb, pb) and torch.equal(ko, po)):
        raise AssertionError("int8 kernel differs from its plain version: max|dbest| "
                             "%g, %d argoffs" % (err, int((ko != po).sum())))
    return err


def launched(dtype):
    return align_reduce.launches_by_dtype[dtype]


def self_queries(rng, db_np, R, n_songs, S, B, d, noise=0.1):
    """Noisy windows of the layout itself, renormalised (bench.py style)."""
    q = np.zeros((B, S, d), np.float32)
    src = rng.integers(0, n_songs, size=B)
    for b in range(B):
        start = src[b] * R + rng.integers(0, R - S + 1)
        q[b] = db_np[start : start + S] + noise * rng.standard_normal((S, d))
    q /= np.linalg.norm(q, axis=2, keepdims=True)
    return q, src


def make_song(rng, n_sec, sr=8000):
    """Random note sequence, 3 partials a note (tests/test_e2e.py style)."""
    note_len = sr // 4
    x = np.zeros(n_sec * sr, dtype=np.float64)
    t_note = np.arange(note_len) / sr
    env = np.minimum(np.minimum(np.arange(note_len), np.arange(note_len)[::-1])
                     / (note_len / 8), 1.0)
    for k in range(n_sec * 4):
        for _ in range(3):
            f = rng.uniform(150, 3400)
            x[k * note_len : (k + 1) * note_len] += (
                rng.uniform(0.3, 1.0) * env
                * np.sin(2 * np.pi * f * t_note + rng.uniform(0, 2 * np.pi))
            )
    x /= np.max(np.abs(x)) * 1.2
    return x.astype(np.float32)


def screen_scenario(dev, card) -> dict:
    """Phase 6: the screened engine at 100k songs (bench.py --scale 100000
    with an int8 stage 1).  Returns the int8 kernel's numbers for the
    kernels line and the launches of the runs it drove."""
    phase(6, "screened engine: 100k songs x 120 rows, d=128, k=4, top_m=32, "
             "bf16 exact layout, int8 stage 1, rescue 0.4")
    n_songs, per, d, S, B, k = 100_000, 120, 128, 19, 1024, 4
    tm = time.time()
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((n_songs * per, d), dtype=np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    counts = np.full(n_songs, per)
    gen_s = time.time() - tm

    def batch(seed, n, noise):
        r = np.random.default_rng(seed)
        src, off = r.integers(0, n_songs, size=n), r.integers(0, per - S, size=n)
        f = emb[(src * per + off)[:, None] + np.arange(S)]
        f += noise * r.standard_normal(f.shape, dtype=np.float32)
        f /= np.linalg.norm(f, axis=2, keepdims=True)
        return f, src, off

    kw = dict(pad=32, k=k, top_m=32, score_dtype=torch.bfloat16, coarse_dtype="int8",
              device=dev, rescue_threshold=0.4)
    tm = time.time()
    eng = ScreenedAlignmentEngine(emb, counts, **kw)
    torch.cuda.synchronize()
    print("  corpus %.1f s; engine build %.1f s: R=%d Rc=%d n_pad=%d, resident %.1f MB "
          "(bf16 exact layout %.1f MB + int8 coarse copy %.1f MB)" % (
              gen_s, time.time() - tm, eng.R, eng.Rc, eng.n_pad, eng.resident_bytes() / 1e6,
              eng._db3.numel() * 2 / 1e6, eng._coarse.numel() / 1e6), flush=True)

    # 1,024 clean queries through the serving call
    f, src, off = batch(1, B, 0.1)
    eng.search_top1(f[:64])  # first calls: sort and cuBLAS set-up
    reset_launch_counts()
    esc0 = eng.escalated
    song, _, t = eng.search_top1(f)
    torch.cuda.synchronize()
    n8, n16 = launched(torch.int8), launched(torch.bfloat16)
    esc_clean = eng.escalated - esc0
    hits, right = int((song == src).sum()), int((t == off).sum())
    print("  clean batch: recall %d/%d, offsets right %d/%d, escalated %d, launches "
          "int8 %d bf16 %d" % (hits, B, right, B, esc_clean, n8, n16), flush=True)
    if n8 <= 0:
        raise AssertionError("the screened path never launched the int8 kernel")
    if hits != B or right != B:
        raise AssertionError("screened recall %d/%d, offsets %d/%d" % (hits, B, right, B))
    batch_ms = time_ms(lambda: eng.search_top1(f), 3)
    lens = np.full(B, S)
    bare_ms = time_ms(lambda: eng.search_top1_device(f, lens, rescued=False), 3)
    gated_ms = time_ms(lambda: eng.search_top1_device(f, lens), 3)
    qd = torch.from_numpy(f).to(dev)
    qc8 = quantize_queries_int8(collapse_queries(qd, k))
    Sc = qc8.shape[1]
    s1_ms = time_ms(lambda: align_reduce(eng._coarse, qc8, eng.Rc, Sc, eng.n_pad), 5)
    err8 = compare_exact(eng._coarse, qc8[:64].contiguous(), eng.Rc, Sc, eng.n_pad)
    s1_plain_ms = time_ms(
        lambda: align_reduce_reference(eng._coarse, qc8, eng.Rc, Sc, eng.n_pad), 1)
    best_c = align_reduce(eng._coarse, qc8, eng.Rc, Sc, eng.n_pad)[0]
    sort_ms = time_ms(lambda: torch.sort(best_c, dim=1, descending=True, stable=True), 3)
    del best_c
    torch.cuda.empty_cache()
    print("  search_top1 %.4f s/batch = %.1f queries/s; stages 1+2 on the device %.3f ms, "
          "with the stage-3 gate (one sync) %.3f ms; int8 stage-1 launch (Sc=%d) %.3f ms, "
          "its plain version %.3f ms; top-M stable sort of [%d, %d] %.3f ms; int8 kernel "
          "== plain on 64 queries, bitwise  %s" % (
              batch_ms / 1e3, B / (batch_ms / 1e3), bare_ms, gated_ms, Sc, s1_ms,
              s1_plain_ms, B, eng.n_pad, sort_ms, card), flush=True)

    # 256 noisy queries: the winner-drop regime; stage 3 must escalate some
    fn, srcn, _ = batch(2, 256, 0.46)
    reset_launch_counts()
    esc0 = eng.escalated
    song_n, _, t_n = eng.search_top1(fn)
    torch.cuda.synchronize()
    esc_noisy = eng.escalated - esc0
    n8 += launched(torch.int8)
    n16 += launched(torch.bfloat16)
    if esc_noisy < 1 or launched(torch.bfloat16) < 1:
        raise AssertionError("the noisy batch escalated %d queries" % esc_noisy)
    noisy_ms = time_ms(lambda: eng.search_top1(fn), 1)
    del eng, qd, qc8
    torch.cuda.empty_cache()
    full = AlignmentEngine(emb, counts, score_dtype=torch.bfloat16, device=dev)
    (fb, fo), = full.search_device(fn)
    top2 = fb.topk(2, dim=1).values
    clear = ((top2[:, 0] - top2[:, 1]) > BEST_ATOL).cpu().numpy()
    fsong, _, ft = (x.cpu().numpy() for x in _top1(fb, fo, full.pad))
    same = (song_n == fsong) & (t_n == ft)
    if not same[clear].all():
        raise AssertionError("noisy batch: %d answers differ from the exhaustive "
                             "engine's where its margin is clear" % int((~same[clear]).sum()))
    full_ms = time_ms(lambda: full.search_top1(fn), 1)
    print("  noisy batch (noise 0.46, 256 queries): escalated %d, answers == exhaustive "
          "on %d/%d with a clear margin (%d/256 equal in all), right song %d/256; "
          "screened %.3f ms, exhaustive %.3f ms  %s" % (
              esc_noisy, int(same[clear].sum()), int(clear.sum()), int(same.sum()),
              int((song_n == srcn).sum()), noisy_ms, full_ms, card), flush=True)
    del full, fb, fo
    torch.cuda.empty_cache()

    # the same corpus with an int8 exact layout
    tm = time.time()
    eng8 = ScreenedAlignmentEngine(emb, counts, exact_dtype="int8", **kw)
    torch.cuda.synchronize()
    build8_s = time.time() - tm
    reset_launch_counts()
    song8, _, t8 = eng8.search_top1(f)
    n8 += launched(torch.int8)
    hits8, right8 = int((song8 == src).sum()), int((t8 == off).sum())
    if hits8 != B or right8 != B:
        raise AssertionError("int8 exact layout: recall %d/%d, offsets %d/%d"
                             % (hits8, B, right8, B))
    ms8 = time_ms(lambda: eng8.search_top1(f), 3)
    print("  int8 exact layout: build %.1f s, resident %.1f MB, recall %d/%d, offsets "
          "right %d/%d, %.4f s/batch = %.1f queries/s  %s" % (
              build8_s, eng8.resident_bytes() / 1e6, hits8, B, right8, B, ms8 / 1e3,
              B / (ms8 / 1e3), card), flush=True)
    del eng8
    torch.cuda.empty_cache()
    return {"launches_int8": n8, "launches_bf16": n16, "max_abs_err": err8,
            "ms": s1_ms, "plain_ms": s1_plain_ms}


def main() -> None:
    # ---------------------------------------------------------------- 1
    phase(1, "card")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0].strip()
    print(smi)
    card = "[%s]" % smi
    dev = torch.device("cuda", 0)
    print("torch %s cuda %s python %s device %s (%d visible)" % (
        torch.__version__, torch.version.cuda, sys.version.split()[0],
        torch.cuda.get_device_name(0), torch.cuda.device_count()))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---------------------------------------------------------------- 2
    phase(2, "build")
    tm = time.time()
    lib = align_kernel.build()
    print("built %s in %.2f s (cached=%s)" % (
        os.path.relpath(lib, REPO), time.time() - tm, align_kernel.build_info["cached"]))
    for line in align_kernel.build_info.get("log", "").splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print("  ptxas:", line.strip())

    # ---------------------------------------------------------------- 3
    phase(3, "kernel vs plain on the card")
    max_err = 0.0
    rng = np.random.default_rng(0)
    d = 128
    counts = rng.integers(40, 121, size=1000)
    emb = rng.standard_normal((int(counts.sum()), d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    for pad, S_list in ((32, (19, 24, 32)), (128, (119,))):
        db_np, R = build_uniform_layout(emb, counts, pad=pad)
        for dtype in (torch.bfloat16, torch.float32):
            db = torch.from_numpy(db_np).to(dev, dtype)
            for S in S_list:
                q_all, _ = self_queries(rng, db_np, R, len(counts), S, 1024, d)
                for B in (1, 100, 1024):
                    q = torch.from_numpy(q_all[:B]).to(dev, dtype)
                    err, nbad, _ = compare(db, q, R, S, len(counts))
                    max_err = max(max_err, err)
                    k_ms = time_ms(lambda: align_reduce(db, q, R, S, len(counts)), 3)
                    p_ms = time_ms(
                        lambda: align_reduce_reference(db, q, R, S, len(counts)), 1)
                    print("  %-8s pad %3d S %3d B %4d: kernel %9.3f ms  plain %9.3f ms"
                          "  max|dbest| %.2e  argoff ties %d  %s" % (
                              str(dtype).split(".")[1], pad, S, B, k_ms, p_ms,
                              err, nbad, card), flush=True)
            del db
    torch.cuda.empty_cache()
    # the int8 variant on the same corpus, pooled and quantized as stage 1
    # of the screened engine sees it: Sc = ceil(S / 4) in {5, 6, 8, 30}
    int8_err = 0.0
    for pad, S_list in ((32, (19, 24, 32)), (128, (119,))):
        db3, coarse, R, Rc, n_pad = build_screen_layout(emb, counts, pad=pad, k=4, d=d)
        c8 = torch.from_numpy(quantize_coarse_int8(coarse)).to(dev)
        flat = db3.reshape(-1, d)
        for S in S_list:
            q_all, _ = self_queries(rng, flat, R, n_pad, S, 1024, d)
            qc8 = quantize_queries_int8(
                collapse_queries(torch.from_numpy(q_all).to(dev), 4))
            Sc = qc8.shape[1]
            for B in (1, 100, 1024):
                q = qc8[:B].contiguous()
                int8_err = max(int8_err, compare_exact(c8, q, Rc, Sc, n_pad))
                k_ms = time_ms(lambda: align_reduce(c8, q, Rc, Sc, n_pad), 3)
                p_ms = time_ms(lambda: align_reduce_reference(c8, q, Rc, Sc, n_pad), 1)
                print("  int8     pad %3d Sc %3d B %4d: kernel %9.3f ms  plain %9.3f ms"
                      "  bitwise equal  %s" % (pad, Sc, B, k_ms, p_ms, card), flush=True)
        del c8, db3, coarse, flat
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 4
    phase(4, "bench.py scenario: 10k songs x 120 rows, bf16, S=19, B=1024")
    rng = np.random.default_rng(0)
    n_songs, per, S, B = 10_000, 120, 19, 1024
    emb = rng.standard_normal((n_songs * per, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    engine = AlignmentEngine(emb, np.full(n_songs, per), score_dtype=torch.bfloat16,
                             device=dev)
    print("  resident layout %.1f MB (%d rows, R=%d)" % (
        engine._db.numel() * 2 / 1e6, engine._db.shape[0], engine.R))

    def bench_batch(seed, noise=0.1):
        r = np.random.default_rng(seed)
        f = np.zeros((B, S, d), np.float32)
        src, off = r.integers(0, n_songs, size=B), r.integers(0, per - S, size=B)
        for b in range(B):
            f[b] = emb[src[b] * per + off[b] :][:S]
        f += noise * r.standard_normal(f.shape).astype(np.float32)
        f /= np.linalg.norm(f, axis=2, keepdims=True)
        return f, src, off

    f, src, off = bench_batch(1)
    song, _, t = engine.search_top1(f)
    hits = int((song == src).sum())
    print("  recall %d/%d, offsets right %d/%d" % (hits, B, int((t == off).sum()), B))
    if hits != B:
        raise AssertionError("recall sanity failed: %d/%d" % (hits, B))
    q = torch.from_numpy(f).to(dev, torch.bfloat16)
    err, nbad, _ = compare(engine._db, q[:64], engine.R, S, n_songs)
    max_err = max(max_err, err)
    kernel_ms = time_ms(lambda: align_reduce(engine._db, q, engine.R, S, n_songs), 5)
    # the plain version at its 1 GiB default score-tensor cap (9 queries a
    # chunk here) and at 16 GiB (148 a chunk, more than phase 3's 92)
    plain_by_cap = {}
    for cap in (1 << 30, 16 << 30):
        align_kernel.REFERENCE_SCORE_BYTES = cap
        plain_by_cap[cap] = time_ms(
            lambda: align_reduce_reference(engine._db, q, engine.R, S, n_songs), 1)
        torch.cuda.empty_cache()
    qb = q[:32].contiguous()  # the matcher's default batch (--batch 32, fsm 1)
    k32 = time_ms(lambda: align_reduce(engine._db, qb, engine.R, S, n_songs), 5)
    p32 = time_ms(lambda: align_reduce_reference(engine._db, qb, engine.R, S, n_songs), 3)
    align_kernel.REFERENCE_SCORE_BYTES = 1 << 30
    plain_ms = min(plain_by_cap.values())
    flops = 2.0 * engine._db.shape[0] * d * S * B
    print("  kernel %.4f s/batch = %.1f queries/s (%.1f TFLOP/s f32-FMA work); "
          "plain %.4f s/batch (1 GiB chunks) %.4f s/batch (16 GiB chunks) = %.1f "
          "queries/s at the faster; max|dbest| %.2e (64 queries)  %s" % (
              kernel_ms / 1e3, B / (kernel_ms / 1e3), flops / kernel_ms / 1e9,
              plain_by_cap[1 << 30] / 1e3, plain_by_cap[16 << 30] / 1e3,
              B / (plain_ms / 1e3), err, card), flush=True)
    print("  B=32: kernel %.3f ms, plain %.3f ms (one chunk)  %s" % (k32, p32, card),
          flush=True)
    del engine, q, qb, emb
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 5
    phase(5, "slice: builder + matcher at flagship width")
    with open(os.path.join(REPO, "configs", "default.json")) as fh:
        cfg = json.load(fh)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        rng = np.random.default_rng(7)
        songs = []
        for i in range(64):
            wav = make_song(rng, 30)
            path = os.path.join(tmp, "song%02d.wav" % i)
            write_wav(path, wav, 8000)
            songs.append((path, wav))
        model_dir = os.path.join(tmp, "model")
        os.makedirs(model_dir)
        cfg.update(model_dir=model_dir, cache_dir=os.path.join(tmp, "caches"))
        with open(os.path.join(model_dir, "configs.json"), "w") as fh:
            json.dump(cfg, fh, indent=2)
        torch.manual_seed(0)
        save_model(os.path.join(model_dir, "model.msgpack"),
                   build_fp_network(cfg).state_dict())
        lst = os.path.join(tmp, "songs.txt")
        with open(lst, "w") as fh:
            fh.writelines(p + "\n" for p, _ in songs)
        qdir = os.path.join(tmp, "queries")
        os.makedirs(qdir)
        truth = []
        for qi in range(16):
            s = int(rng.integers(0, 64))
            start = int(rng.integers(0, 20)) * 4000  # hop-aligned, 10 s crops
            qpath = os.path.join(qdir, "q%02d.wav" % qi)
            write_wav(qpath, songs[s][1][start : start + 80000], 8000)
            truth.append((qpath, songs[s][0], start / 8000))
        qlist = os.path.join(tmp, "queries.txt")
        with open(qlist, "w") as fh:
            fh.writelines(q + "\n" for q, _, _ in truth)
        db_dir = os.path.join(tmp, "db")
        res = os.path.join(tmp, "out", "result.txt")
        res1 = os.path.join(tmp, "out", "result_top1.txt")

        reset_launch_counts()
        tm = time.time()
        builder.main(["builder", lst, db_dir, model_dir, "--device", "cuda"])
        build_s = time.time() - tm
        tm = time.time()
        matcher.main(["matcher", qlist, db_dir, res, "--device", "cuda"])
        matcher.main(["matcher", qlist, db_dir, res1, "--top1", "--device", "cuda"])
        torch.cuda.synchronize()
        match_s = time.time() - tm
        launches = launched(torch.bfloat16) + launched(torch.float32)
        print("  builder %.2f s, matcher x2 %.2f s, kernel launches %d  %s" % (
            build_s, match_s, launches, card))
        if launches <= 0:
            raise AssertionError("the main path never launched the kernel")

        for name in ("embeddings", "landmarkKey", "songList.txt", "configs.json",
                     "model.msgpack", "index_meta.json"):
            if not os.path.exists(os.path.join(db_dir, name)):
                raise AssertionError("DB lacks " + name)
        counts = np.fromfile(os.path.join(db_dir, "landmarkKey"), np.int32)
        if counts.tolist() != [59] * 64:
            raise AssertionError("landmarkKey %s" % counts.tolist()[:8])
        dbe = np.fromfile(os.path.join(db_dir, "embeddings"), np.float32).reshape(-1, 128)
        norms = np.linalg.norm(dbe, axis=1)
        if dbe.shape != (64 * 59, 128) or np.abs(norms - 1).max() > 1e-3:
            raise AssertionError("embeddings %s, norms %s" % (dbe.shape, norms[:4]))
        lines = open(res).read().splitlines()
        answers = [ln.split("\t")[1] for ln in lines]
        if len(lines) != 16 or "error" in answers:
            raise AssertionError("TSV: %s" % lines)
        if open(res1).read() != open(res).read():
            raise AssertionError("--top1 TSV differs from the default TSV")
        n_bin = np.fromfile(res + ".bin", np.float32).size
        if n_bin != 16 * 64 * 2:
            raise AssertionError(".bin holds %d floats" % n_bin)
        hits = sum(a == s for a, (_, s, _) in zip(answers, truth))
        print("  DB %s rows, TSV %d lines, top1 == default, .bin %d floats, "
              "right song %d/16 (random weights)" % (dbe.shape[0], len(lines), n_bin, hits))

        # the same DB and query embeddings through the plain version
        params = json.load(open(os.path.join(db_dir, "configs.json")))
        emb_q = Embedder(params, os.path.join(db_dir, "model.msgpack"), dev, chunk=2048)
        db = Database(db_dir, params["indexer"], params["hop_size"], dev)
        raw = list(MusicDataset(qlist, params).iterate_raw())
        zs = emb_q.embed_songs([r[2] for r in raw], [r[3] for r in raw], 4000)
        filters, lens = db._filters(zs)
        eng = db._align
        qf = torch.from_numpy(filters).to(dev, eng.score_dtype)
        err, nbad, (kb, _) = compare(eng._db, qf, eng.R, qf.shape[1], eng.n_songs)
        max_err = max(max_err, err)
        pb, po = align_reduce_reference(eng._db, qf, eng.R, qf.shape[1], eng.n_songs)
        song, ssum, t = (x.cpu().numpy() for x in _top1(pb, po, eng.pad))
        mean = pb.cpu().numpy() / np.maximum(lens, 1)[:, None]
        top2 = np.sort(mean, axis=1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > BEST_ATOL
        with open(os.path.join(tmp, "out", "result_detail.csv")) as fh:
            detail = list(csv.reader(fh))[1:]
        agree = 0
        for i in np.flatnonzero(clear):
            want = (db.songList[song[i]], float(t[i]) * params["hop_size"])
            got = (detail[i][1], float(detail[i][3]))
            if want != got:
                raise AssertionError("query %d: matcher %s, plain version %s" % (i, got, want))
            agree += 1
        if agree == 0:
            raise AssertionError("no query had a clear top-1 margin to check")
        print("  matcher answers == plain-version answers on %d/16 queries with a "
              "clear margin; kernel vs plain max|dbest| %.2e" % (agree, err))
        del db, eng, emb_q

        # the same DB through the screened engine: top 64 of 64 songs makes
        # the screen a reordering, so the answers are the align engine's
        cfg_path = os.path.join(db_dir, "configs.json")
        with open(cfg_path) as fh:
            params = json.load(fh)
        params["indexer"].update(screen=True, screen_coarse_dtype="int8", screen_top_m=64)
        with open(cfg_path, "w") as fh:
            json.dump(params, fh, indent=2)
        res_s = os.path.join(tmp, "out", "result_screen.txt")
        res_s1 = os.path.join(tmp, "out", "result_screen_top1.txt")
        reset_launch_counts()
        tm = time.time()
        matcher.main(["matcher", qlist, db_dir, res_s, "--device", "cuda"])
        matcher.main(["matcher", qlist, db_dir, res_s1, "--top1", "--device", "cuda"])
        torch.cuda.synchronize()
        screen_s = time.time() - tm
        launches_int8 = launched(torch.int8)
        screen_bf16 = launched(torch.bfloat16)
        launches += screen_bf16
        print("  screened matcher x2 %.2f s, int8 launches %d, bf16 (rescue) launches "
              "%d  %s" % (screen_s, launches_int8, screen_bf16, card))
        if launches_int8 <= 0:
            raise AssertionError("the screened matcher never launched the int8 kernel")
        want = open(res, "rb").read()
        for path in (res_s, res_s1):
            if open(path, "rb").read() != want:
                raise AssertionError("%s differs from the align engine's TSV"
                                     % os.path.basename(path))
        print("  screened TSVs (default, --top1) == the align engine's TSV")

    shot = screen_scenario(dev, card)
    launches_int8 += shot["launches_int8"]
    launches += shot["launches_bf16"]

    print(json.dumps({"kernels": [{
        "name": "align_reduce",
        "route": "cuda",
        "source": "pfann_tpu_torch/csrc/align_reduce.cu",
        "replaces": "pfann_tpu/index/pallas_align.py:45",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }, {
        "name": "align_reduce_int8",
        "route": "cuda",
        "source": "pfann_tpu_torch/csrc/align_reduce.cu",
        "replaces": "pfann_tpu/index/pallas_align.py:49",
        "launches": launches_int8,
        "max_abs_err": max(int8_err, shot["max_abs_err"]),
        "ms": shot["ms"],
        "plain_ms": shot["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
