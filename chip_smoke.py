#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pfann_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits nonzero:

  1. the card: nvidia-smi name and power limit, torch and CUDA versions.
     No CUDA, no run.
  2. build the align-reduce kernel from pfann_tpu_torch/csrc/ with nvcc.
  3. kernel against its plain PyTorch version on the card: bf16 and f32;
     pad 32 with S in {19, 24, 32} and pad 128 with S = 119; B in
     {1, 100, 1024}; ~1k songs of 40-120 rows at d = 128.
  4. the serving scenario of bench.py: 10,000 songs x 120 rows, d = 128,
     bf16, S = 19, 1,024 noisy self-queries; recall must be 1024/1024.
     Times the kernel against the plain version at B = 1024 and at the
     matcher's default batch of 32.
  5. the slice through the entry points: a 64-song x 30 s synthetic
     corpus, a flagship-width model (configs/default.json: d=128, h=1024,
     u=32, fuller) with random weights from a seed, saved with the port's
     writer; pfann_tpu_torch.builder, then pfann_tpu_torch.matcher in
     default and --top1 mode on 16 hop-aligned 10 s crops.

The line before the last is a JSON object describing each kernel; the
last line is {"ok": true, "device": {...}}.
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
)
from pfann_tpu_torch.index.database import Database  # noqa: E402
from pfann_tpu_torch.index.embedder import Embedder  # noqa: E402
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

        align_reduce.launches = 0
        tm = time.time()
        builder.main(["builder", lst, db_dir, model_dir, "--device", "cuda"])
        build_s = time.time() - tm
        tm = time.time()
        matcher.main(["matcher", qlist, db_dir, res, "--device", "cuda"])
        matcher.main(["matcher", qlist, db_dir, res1, "--top1", "--device", "cuda"])
        torch.cuda.synchronize()
        match_s = time.time() - tm
        launches = align_reduce.launches
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

    print(json.dumps({"kernels": [{
        "name": "align_reduce",
        "route": "cuda",
        "source": "pfann_tpu_torch/csrc/align_reduce.cu",
        "replaces": "pfann_tpu/index/pallas_align.py:45",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
