#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pfann_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits nonzero:

  1. the card: nvidia-smi name and power limit, torch and CUDA versions.
     No CUDA, no run.
  2. build the align-reduce kernel from pfann_tpu_torch/csrc/ with nvcc
     (its four parts in parallel); print ptxas's registers, shared memory
     and spills per instantiation (one that spills fails, and so does one
     whose wgmma ptxas serialised), and count the tensor-core instructions
     (HMMA / IMMA, HGMMA / IGMMA) and FFMA in the SASS of each: a bf16
     instantiation without HGMMA, an int8 one without IGMMA, any with
     HMMA or IMMA (mma.sync), or an f32 one with tensor-core instructions
     or without FFMA, fails.
  3. kernel against its plain PyTorch version on the card: bf16 and f32;
     pad 32 with S in {19, 24, 32} and pad 128 with S = 119; B in
     {1, 100, 1024}; ~1k songs of 40-120 rows at d = 128.  Then the int8
     variant against its plain version, bitwise: the same corpus pooled
     and quantized as the screened engine's stage 1 sees it (k = 4),
     Sc in {5, 6, 8, 30}, B in {1, 100, 1024}.
  4. the serving scenario of bench.py: 10,000 songs x 120 rows, d = 128,
     bf16, S = 19, 1,024 noisy self-queries; recall must be 1024/1024.
     Times the kernel against the plain version at B = 1024 and at the
     matcher's default batch of 32, each held to the plain version first.
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
     margin is clear), the int8 stage-1 launch against its plain version on
     all 1,024 queries (bitwise) and the bf16 stage-3 launch against its
     plain version on the 256, and the same corpus with an int8 exact
     layout.  Then db_dtype float32 on the same corpus: the screened
     engine with an f32 exact layout and its default f32 stage 1, (f2) the
     1,024 clean queries (recall 1024/1024) and the f32 stage-1 launch
     alone, (f3) the 256 noisy ones, which escalate to the f32 rescue
     (answers equal the exhaustive f32 engine's where its margin is clear),
     and the f32 stage-3 launch alone.
  7. the rest of serving, through Database and the CLIs; these paths run
     as torch ops (or on the host) and must launch no align-reduce kernel
     where they do not reach the fast engines:
     (a) phase 4's corpus written as a DB directory (0.61 GB of f32
         embeddings), align engine at pad 32, 32 noisy 60 s queries (119
         rows): the topk fallback, recall 32/32; (b) engine topk, top_k
         100, 32 queries of 19 rows, recall 32/32; both held to the
         native C++ core (native/seqscore.cpp, f32 on the host) on 4
         queries;
     (c) score_alpha 1.0 on the exhaustive engine, 256 queries, recall
         256/256, held to the CPU alpha path on 1,000 songs;
     (f1) db_dtype float32 on the exhaustive engine: 1,024 and 32 noisy
         queries of 19 rows through query_top1_batch, one f32 launch each,
         recall 1024/1024 and 32/32; at both, the f32 launch the path
         makes (the Database's top-1 filters: 19 windows, unpadded)
         held to its plain version and timed;
     (d) score_alpha 1.0 on the screened engine on phase 6's corpus, 256
         clean queries, recall 256/256, answers equal the exhaustive
         alpha engine's where its margin is clear;
     (e) on phase 5's DB: matcher --visualize (16 PNGs of saliency_image's
         shape, the default TSV), extractemb -> matchemb on both engines
         and matcher after rebuild (the default TSV), matchfromgt (the
         crops' songs and offsets), cppmatcher (recall 16/16).
  8. the landmark front end (pfann_tpu_torch/landmark/device.py, torch
     ops, no align-reduce kernel): (a) DevicePeakExtractor (batch 32,
     pipeline 4) on 256 songs x 30 s at 8 kHz in int16 (bench.py's
     landmark songs), after a warm-up on 32 other songs; audio-s/s of the
     card and of the numpy host path (core.extract_hashes), hash
     agreement >= 0.999 with the host path; on 8 of the songs the card
     against the same torch code on the CPU, where every differing peak
     must lie within 1e-3 of the median gate or of a tie in its window;
     (b) lm_builder then lm_matcher on phase 5's corpus and crops, with
     the card extractor and with PFANN_LM_DEVICE=0 (the numpy path):
     recall 16/16, the two TSVs equal, the .bin entries that differ
     counted; wall s of each.  No landmark path may launch align_reduce.
  9. training on the card (torch ops, no align-reduce kernel on its
     paths): (a) the flagship train step (configs/default.json widths,
     bf16 compute, Adam) at 640 and 1,280 rows and the LAMB step at 640:
     ms a step by CUDA events over 8 distinct batches after 2 warm-up
     steps, optimizer.step alone, the first loss (within 10% of
     log(n - 1)), the global grad norm (finite), peak memory, the step's
     FLOPs (3 x the forward's, counted from the conv and projector
     shapes) and their share of the bf16 dense peak; and one f32 step
     (TF32 off) on 32 rows held to the same step on the CPU, with ReLU
     (loosely: a ReLU input at the kink may flip) and ELU (tightly); (b) a
     synthetic corpus (tools.make_synth_corpus: 60 train, 10 val, 16 test
     songs x 30 s), python -m pfann_tpu_torch.train for 2 epochs in a
     child process with the real loader (noise, room IR, mic IR on the
     card): finite losses, the checkpoint contract's files, validation
     top-1/10; the rerun (in-process) reports a finished model; builder
     + matcher with the trained model on 16 hop-aligned 10 s crops
     (recall 16/16, the bf16 kernel launched); export_model of epoch 0
     equal to checkpoint 0's params; (c) epoch 2's wall, segments/s, the
     loader's host and dispatch seconds (metrics.jsonl), the augment
     program alone a batch, and which of host and card sets the pace;
     (d) the --mock CLI (in-process) at 640 rows a step.
 10. the multi-GPU paths on one card (pfann_tpu_torch/parallel/): (a)
     phase 6's corpus sharded over [cuda:0, cuda:0] (ShardedDatabase,
     screened engine, int8 stage 1, rescue 0.4): per-shard resident MB,
     1,024 clean queries (recall 1024/1024, answers equal phase 6's
     unsharded engine, one int8 launch per shard) and phase 6's 256 noisy
     ones (answers equal the exhaustive engine's where its margin is
     clear, one bf16 launch per shard per escalating chunk), ms a batch
     beside phase 6's, one batch under utils/profiling.device_trace with
     its five longest device ops, one shard's int8 stage-1 launch held to
     its plain version bitwise; (b) phase 4's corpus as a DB directory
     through Database with sharded: true over the same two devices:
     recall 1024/1024, answers equal phase 4's where the top-1 margin is
     clear, one bf16 launch per shard, ms a batch beside phase 4's, one
     shard's launch held to its plain version; (c) the data-parallel train
     step as 2 gloo ranks on the card (processes; NCCL refuses two ranks
     on one card), held to the one-process step on the same batch, draws
     and weights: f32 (ELU, TF32 off) on 32 rows tightly and the flagship
     bf16 step at 640 rows; ms a step and of the gradient all-reduce; (d)
     python -m pfann_tpu_torch.train --dp for 1 epoch on phase 9's
     synthetic corpus (one NCCL rank per visible card): "data-parallel
     over N devices" and the checkpoint contract's files.  (c)'s ranks
     report their align-reduce launches, which must be 0; (d)'s rank is a
     child of a child, whose counts this script cannot read.
 11. the ported bench (pfann_tpu_torch/bench.py, in process, stdout
     captured): every mode of bench.py through the port's engines, each
     JSON line printed and held to bench.py's keys for its mode and this
     card: default with --batch-sweep (10,000 songs; bf16 launches at B =
     128, 256 and 512 as well as 1,024), --sharded, --scale 30000 (bf16
     stage 1 at Sc=5 and the noisy rescue), --scale 30000 --int8-exact
     (int8 only), --long 10000 (bf16 coarse stage at Sc=30), --db on phase
     7's 10k-song DB directory as written (bf16), with db_dtype float32
     (f32 only) and with screen: true (int8 stage 1, bf16 control and
     rescue), --lm 256, --build 256 and --train-epoch on phase 9's
     synthetic config (no align-reduce launch).  The bf16 launches no
     earlier phase makes at their scale are held to the plain version and
     timed: stage 1 at 30k songs, the Sc=30 coarse stage, the sweep's
     B = 128, 256 and 512.
 12. the evaluation harness (pfann_tpu_torch/tools/run_synth_pipeline.py,
     a child process tree in a scratch root): the v2 family corpus at
     --db-songs 100 (a 130-track DB), the train CLI at configs/synth.json's
     widths (d=64, h=512, u=16) for its 40 epochs, genall at 10 s and 3 s
     (--num-queries 100 a SNR), testall for the NN and landmark arms on
     both lengths, fuse (where scikit-learn is installed) and the fsm sweep
     at fsm=2 (--fsm 2; the driver's default adds 4), the per-SNR steps 8
     at once (--jobs 8): PIPELINE_DONE, each step's wall, the per-SNR accuracy lines
     and their bands (song top-1: NN 10 s >= 95% at every SNR, NN 3 s >=
     60% at -6 dB and >= 90% at +8 dB, landmark 10 s >= 90%; fsm=2's
     exact-match top-1 >= fsm=1's at every SNR).  Each port process under
     the driver logs its align-reduce launches (PFANN_LAUNCH_LOG) as it
     exits.  Then the -6 dB 10 s set through the port's matcher on the
     CPU, in this process: its TSV equals the card's wherever the card's
     top-1 margin is at least 4e-2, every score within 2e-2.
 13. the round-4 screen validation on phase 12's outputs (tools.r04_pipeline
     then tools.r04_rescue, child processes, --jobs 8): the rescued screen's answers
     (ids and times) equal the exhaustive control's on every query of every
     SNR; ACCURACY_r04.md's rows.  In this process, the rescued screen over
     each SNR's query embeddings (the share of queries escalated to stage
     3), and the kernel shapes the harness launches held to the plain
     version and timed: bf16 stage 1 and stage 3 of the rescued screen,
     int8 stage 1 of screeni8, the bf16 exhaustive engine at d=64 and B=128
     on 10 s queries (19 rows, S=24 bucketed) and on 5-row ones (the 3 s
     sets' length, S=8).
 14. the screen at its auto-activation scale (tools.r04_scale30k, then
     tools.r04_scale30k_resume, child processes) on phases 12-13's root:
     29,870 distractors of 2 s (written in the background by the driver's
     own command while phases 6-13 run; the driver then skips the step, as
     the script does) make the 130-track DB 30,000 songs, served by the
     screen with no override, the {"screen": false} control by the
     exhaustive engine (Database's choice, and each matchemb process's
     bf16 launches); the auto engine's answers (ids and times) equal the
     control's on every query of every SNR; BENCH_r04_db30k.json's lines.
     In this process, the escalation share per SNR at 30,000 songs and
     the kernel shapes held to the plain version and timed: bf16 stage 1
     and stage 3 of the screen and the exhaustive engine at B=128, d=64.
 15. round 5 at the flagship's width (d=128, h=1024, u=32), child
     processes that run beside phase 14's (both chains spend most of
     their wall starting processes): the train CLI for 1 epoch on a copy of
     configs/flagship.json with only epoch changed (its corpus, 60 + 10
     songs of 30 s, written in the background), the builder's
     flagship_30kbase from phase 12's 130-track list, tools.r05_calibrate
     (three cover corpora of 8 songs, NQ=8) and tools.r05_flagship (20
     songs of 12 s and 4 of 64 s, NQ10=8, NQ60=2, COVER_SUB 0.03,
     COVER_JITTER 0.02) through their environment: CALIBRATE_DONE,
     R05_PIPELINE_DONE, every accuracy block, the 60 s sets' engine (the
     matcher's topk-fallback log line; the 10 s sets' bf16 launches), and
     the d=128 exhaustive launch of one 10 s set, held to the plain
     version in this process.
 16. FpNetwork's norm-and-activation kernel (models/norm_act.py,
     csrc/norm_act.cu): built (a spill fails), then at the audio batch's
     16 norm volumes (4,864 segments of the d=128 encoder, bf16, ReLU
     after the norm) held to its plain version (one bf16 ulp, or 1e-5
     near 0) and timed beside it and beside its bound (4 bytes an element
     and the affine once, over the memory rate), and the batch's sum of
     the plan's times printed against its bound.  Its launches on the main
     path are phase 5's builder and matcher runs (16 a forward); phase 5
     fails if they launched none.  tools/torch_kernel_sweep.py --norm-act
     times every form and tile the source builds.

Phases 3, 4, 6, 7 (f1) and 11 print each kernel's time beside its bound (the
larger of the operations over the card's published dense peak for their
type and the bytes over its memory rate, from the shapes), its plain
version's time and a library yardstick that only this script calls:
F.conv1d of the layout as [1, d, N + S - 1] with the queries as [B, d, S]
filters (chunked over queries past 8 GiB of output) and the per-song amax
for bf16 and f32 (TF32 off), and torch._int_mm of the Gram product
[N, d] x [d, Sc*B], chunked, for int8 (the products only: a lower bound on
a library route).

Every kernel shape that is timed is held to the plain version on the
same inputs; each f32 path prints the f32 form's largest |dbest| on a
line of its own.  Each path (phase 5's two engines, phase 6's batches,
phase 7's, 8's, 9's, 10's and 11's in-process paths; 10 (c)'s ranks and
12's to 15's child processes report their own counts) is driven with the kernel's launch counts
set to 0 just before it and read just after; the kernels line gives each
form's (bf16, int8, f32) launches per path.  The line before the last is a JSON object
describing each kernel; the last line is {"ok": true, "device": {...}}.
"""

import collections
import concurrent.futures
import contextlib
import csv
import glob
import io
import json
import math
import os
import re
import shutil
import struct
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from pfann_tpu_torch import (  # noqa: E402
    bench as port_bench,
    builder,
    cppmatcher,
    extractemb,
    lm_builder,
    lm_matcher,
    matchemb,
    matcher,
    matchfromgt,
    rebuild,
)
from pfann_tpu_torch.audio.io import get_audio, write_wav  # noqa: E402
from pfann_tpu_torch.data.musicdata import MusicDataset  # noqa: E402
from pfann_tpu_torch.data.segments import SegmentedDataLoader  # noqa: E402
from pfann_tpu_torch.index import align as align_mod  # noqa: E402
from pfann_tpu_torch.index import align_kernel, native  # noqa: E402
from pfann_tpu_torch.index.align import (  # noqa: E402
    AlignmentEngine,
    _top1,
    build_uniform_layout,
)
from pfann_tpu_torch.index.align_kernel import (  # noqa: E402
    align_reduce,
    align_reduce_reference,
    reset_launch_counts,
    zero_extended,
)
from pfann_tpu_torch.index.database import Database, write_index_meta  # noqa: E402
from pfann_tpu_torch.index.embedder import Embedder  # noqa: E402
from pfann_tpu_torch.index.screen import (  # noqa: E402
    ScreenedAlignmentEngine,
    build_screen_layout,
    collapse_queries,
    quantize_coarse_int8,
    quantize_queries_int8,
)
from pfann_tpu_torch.index.saliency import save_saliency_png  # noqa: E402
from pfann_tpu_torch.landmark import core as lm_core  # noqa: E402
from pfann_tpu_torch.landmark.device import (  # noqa: E402
    DevicePeakExtractor,
    as_device_input,
    log_spectrogram,
    peak_mask,
)
from pfann_tpu_torch.models import norm_act  # noqa: E402
from pfann_tpu_torch.models.fp_network import build_fp_network  # noqa: E402
from pfann_tpu_torch.ops.specaug import SpecAugment  # noqa: E402
from pfann_tpu_torch.parallel import ShardedDatabase  # noqa: E402
from pfann_tpu_torch.parallel.mesh import (  # noqa: E402
    init_data_parallel,
    row_block,
    spawn_ranks,
)
from pfann_tpu_torch.tools import export_model, make_synth_corpus, r04_scale30k  # noqa: E402
from pfann_tpu_torch.train.__main__ import main as train_main  # noqa: E402
from pfann_tpu_torch.train.trainer import Trainer  # noqa: E402
from pfann_tpu_torch.utils import checkpoint as ckpt  # noqa: E402
from pfann_tpu_torch.utils.checkpoint import save_model  # noqa: E402
from pfann_tpu_torch.utils import profiling  # noqa: E402
from pfann_tpu_torch.utils.config import read_file_list  # noqa: E402
from pfann_tpu_torch.utils.rng import seeded_generator  # noqa: E402

REPO = os.path.dirname(os.path.abspath(__file__))
# best may differ from the plain version's by f32 rounding of S*d-term sums
# taken in other orders; offsets may differ only where two offsets score
# within this of each other
BEST_ATOL = 2e-3
# a bf16 DB against the f32 native core: mean window scores (the port
# tests' bf16 tolerance); song and time compared where the top-1 margin
# exceeds it
MEAN_ATOL = 4e-3
# One H100 SXM, dense, from NVIDIA's data sheet: the tensor cores for bf16
# and int8, the CUDA cores for f32 (its kernel runs there); HBM3 rate.
PEAK_OPS = {torch.bfloat16: 989e12, torch.int8: 1979e12, torch.float32: 67e12}
HBM_BYTES_S = 3.35e12


PHASE_START = {}  # phase -> perf_counter at its start


def phase(n, title):
    PHASE_START[n] = time.perf_counter()
    print("== phase %d: %s" % (n, title), flush=True)


def bound(dtype, N, d, S, B, n_songs, R):
    """(ms, "operations" | "bytes"): the least time the card could take
    for one align-reduce call: 2*n_songs*R*d*S*B operations at the peak for
    dtype, against db, queries and outputs (best, argoff) each moved once."""
    item = torch.empty((), dtype=dtype).element_size()
    ops_ms = 2.0 * n_songs * R * d * S * B / PEAK_OPS[dtype] * 1e3
    bytes_ms = (N * d * item + B * S * d * item + B * n_songs * 8) / HBM_BYTES_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def conv_library_ms(db, q, R, S, n_songs, reps, out_bytes=8 << 30):
    """The library yardstick for bf16 and f32: F.conv1d of the layout as
    [1, d, N + S - 1] (zero rows past N) with the queries as [B, d, S]
    filters, then the per-song amax (no argmax), in chunks of queries whose
    [chunk, N] output stays under out_bytes."""
    n0 = n_songs * R
    x = zero_extended(db, max(db.shape[0], n0) + S - 1, db.dtype).T.contiguous()[None]
    w = q.permute(0, 2, 1).contiguous()
    chunk = max(1, out_bytes // (x.shape[2] * x.element_size()))

    def run():
        for b0 in range(0, w.shape[0], chunk):
            wc = w[b0 : b0 + chunk]
            F.conv1d(x, wc)[0, :, :n0].reshape(wc.shape[0], n_songs, R).amax(-1)

    ms = time_ms(run, reps)
    del x, w
    torch.cuda.empty_cache()
    return ms


def int_mm_library_ms(coarse, q8, reps, rows=1 << 18):
    """The library yardstick for int8, a lower bound on a library route:
    torch._int_mm of the Gram product [N, d] x [d, Sc*B] (columns padded to
    a multiple of 8), in chunks of `rows` rows; the products only."""
    B, Sc, d = q8.shape
    n = -(-Sc * B // 8) * 8
    bq = torch.zeros(n, d, dtype=torch.int8, device=q8.device)
    bq[: Sc * B] = q8.reshape(-1, d)
    out = torch.empty(min(rows, coarse.shape[0]), n, dtype=torch.int32, device=q8.device)

    def run():
        for r0 in range(0, coarse.shape[0], rows):
            a = coarse[r0 : r0 + rows]
            if a.shape[0] > 16:  # cuBLASLt's least row count
                torch._int_mm(a, bq.t(), out=out[: a.shape[0]])

    ms = time_ms(run, reps)
    del out, bq
    torch.cuda.empty_cache()
    return ms


def fmt_bound(b):
    return "bound %.4g ms (%s)" % b


# align_reduce_wgmma<Op, NWG, BPS, RS, MT, TN, PP> and
# align_reduce_f32<f32k::Core<WARPS_M, WARPS_N, RM, RN>>, as mangled
_KERNEL_NAME = re.compile(
    r"align_reduce_wgmma.*?(Bf16Op|Int8Op)ELi(\d+)ELi(\d+)ELb([01])ELi(\d+)ELi(\d+)ELb([01])E")
_F32_KERNEL_NAME = re.compile(r"align_reduce_f32.*?CoreILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E")


def kernel_label(mangled):
    """A short name for a kernel instantiation of csrc/align_reduce.cu."""
    m = _KERNEL_NAME.search(mangled)
    if m:  # NWG consumer warpgroups of MT m64 tiles, BPS blocks an SM
        op, nwg, bps, rs, mt, tn, pp = m.groups()
        return "%s TM=%d TN=%d%s%s x%s" % (
            {"Bf16Op": "bf16", "Int8Op": "int8"}[op], 64 * int(mt) * int(nwg), int(tn),
            " rowsum" if rs == "1" else "", " pp" if pp == "1" else "", bps)
    m = _F32_KERNEL_NAME.search(mangled)
    if m:  # warps (M x N) of 8 x 4 lanes, each RM rows x RN queries
        wm, wn, rm, rn = (int(x) for x in m.groups())
        return "f32 TM=%d TN=%d" % (wm * 8 * rm, wn * 4 * rn)
    return mangled


def ptxas_report(log):
    """[(instantiation, its ptxas 'Used ...' line and any spill line)], and
    the instantiations whose wgmma ptxas serialised (advisory C7518 and
    the like: the products would not overlap)."""
    out, serial, name = [], set(), None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = kernel_label(m.group(1))
        elif re.search(r"C75(08|09|10|18)\b", line):
            m = re.search(r"function '(\S+)'", line)
            serial.add(kernel_label(m.group(1)) if m else line.strip())
        elif name and ("Used" in line or "spill" in line):
            out.append((name, line.split(":", 1)[-1].strip()))
    return out, sorted(serial)


def sass_counts(lib_path):
    """{instantiation: Counter of the tensor-core instructions (HMMA/IMMA/
    HGMMA/IGMMA) and FFMA in its SASS}, or None where the toolkit has no
    cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                          check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = kernel_label(m.group(1))
            counts[name] = collections.Counter()
        elif name:
            counts[name].update(re.findall(r"\b(HMMA|IMMA|HGMMA|IGMMA|FFMA)\b", line))
    return counts


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


def exact_scores(db, q, R, S, picks, chunk=4096, alpha=0.0, row_valid=None):
    """float64 align at (b, song, offset) triples, from the definition, on
    db's device (rows past its end read as zero).  With ``alpha``, each
    window's inner product becomes exp(-alpha (1 - ip)^2), masked by
    row_valid [N] (the score_alpha path's definition)."""
    picks = torch.as_tensor(np.asarray(picks, np.int64).reshape(-1, 3), device=db.device)
    out = []
    for p in picks.split(chunk):
        rows = (p[:, 1] * R + p[:, 2])[:, None] + torch.arange(S, device=db.device)
        inside = rows < db.shape[0]
        rows = rows.clamp(max=db.shape[0] - 1)
        ip = (db[rows].double() * q[p[:, 0]].double()).sum(2)
        if alpha:
            ip = torch.exp(-alpha * (1.0 - ip) ** 2) * row_valid[rows].double()
        out.append((ip * inside).sum(1))
    return torch.cat(out).cpu().numpy() if out else np.zeros(0)


def compare(db, q, R, S, n_songs):
    """Kernel vs plain version on the same card tensors.  Returns
    (max |best diff|, #argoff differences, kernel outputs, the plain
    version's ms in this one call, by CUDA events)."""
    kb, ko = align_reduce(db, q, R, S, n_songs)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    pb, po = align_reduce_reference(db, q, R, S, n_songs)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
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
        b, s = bad[:, 0], bad[:, 1]
        a = exact_scores(db, q, R, S, np.stack([b, s, ko[b, s]], 1))
        p = exact_scores(db, q, R, S, np.stack([b, s, po[b, s]], 1))
        if np.abs(a - p).max() > BEST_ATOL:
            raise AssertionError("argoff differs where the margin exceeds %g" % BEST_ATOL)
    return err, len(bad), (kb, ko), plain_ms


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


# launches of the align-reduce kernel per driven path, read just after the
# path ran with the counts set to 0 just before it
PATHS = {}


def record(path):
    PATHS[path] = {"bf16": launched(torch.bfloat16), "f32": launched(torch.float32),
                   "int8": launched(torch.int8)}
    return PATHS[path]


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
          "(bf16 exact layout %.1f MB + int8 coarse copy %.1f MB)  %s" % (
              gen_s, time.time() - tm, eng.R, eng.Rc, eng.n_pad, eng.resident_bytes() / 1e6,
              eng._db3.numel() * 2 / 1e6, eng._coarse.numel() / 1e6, card), flush=True)

    # 1,024 clean queries through the serving call
    f, src, off = batch(1, B, 0.1)
    eng.search_top1(f[:64])  # first calls: sort and cuBLAS set-up
    reset_launch_counts()
    esc0 = eng.escalated
    song, _, t = eng.search_top1(f)
    torch.cuda.synchronize()
    record("6: screened engine, clean batch")
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
    err8 = compare_exact(eng._coarse, qc8, eng.Rc, Sc, eng.n_pad)
    s1_plain_ms = time_ms(
        lambda: align_reduce_reference(eng._coarse, qc8, eng.Rc, Sc, eng.n_pad), 1)
    s1_lib_ms = int_mm_library_ms(eng._coarse, qc8, 3)
    s1_bound = bound(torch.int8, eng._coarse.shape[0], d, Sc, B, eng.n_pad, eng.Rc)
    best_c = align_reduce(eng._coarse, qc8, eng.Rc, Sc, eng.n_pad)[0]
    sort_ms = time_ms(lambda: torch.sort(best_c, dim=1, descending=True, stable=True), 3)
    del best_c
    torch.cuda.empty_cache()
    print("  search_top1 %.4f s/batch = %.1f queries/s; stages 1+2 on the device %.3f ms, "
          "with the stage-3 gate (one sync) %.3f ms; int8 stage-1 launch (Sc=%d) %.3f ms, "
          "its plain version %.3f ms, _int_mm products %.3f ms, %s; top-M stable sort of "
          "[%d, %d] %.3f ms; int8 kernel == plain on all %d queries, bitwise  %s" % (
              batch_ms / 1e3, B / (batch_ms / 1e3), bare_ms, gated_ms, Sc, s1_ms,
              s1_plain_ms, s1_lib_ms, fmt_bound(s1_bound), B, eng.n_pad, sort_ms, B, card),
          flush=True)

    # 256 noisy queries: the winner-drop regime; stage 3 must escalate some
    fn, srcn, _ = batch(2, 256, 0.46)
    reset_launch_counts()
    esc0 = eng.escalated
    song_n, _, t_n = eng.search_top1(fn)
    torch.cuda.synchronize()
    record("6: screened engine, noisy batch")
    esc_noisy = eng.escalated - esc0
    if esc_noisy < 1 or launched(torch.bfloat16) < 1:
        raise AssertionError("the noisy batch escalated %d queries" % esc_noisy)
    noisy_ms = time_ms(lambda: eng.search_top1(fn), 1)
    # stage 3 alone: the bf16 kernel over the whole exact layout, 256 queries
    db3 = eng._db3.view(-1, d)
    q3 = torch.from_numpy(fn).to(dev, torch.bfloat16)
    err3, nbad3, _, _ = compare(db3, q3, eng.R, S, eng.n_pad)
    s3_ms = time_ms(lambda: align_reduce(db3, q3, eng.R, S, eng.n_pad), 3)
    s3_plain_ms = time_ms(lambda: align_reduce_reference(db3, q3, eng.R, S, eng.n_pad), 1)
    s3_lib_ms = conv_library_ms(db3, q3, eng.R, S, eng.n_pad, 1)
    s3_bound = bound(torch.bfloat16, db3.shape[0], d, S, 256, eng.n_pad, eng.R)
    print("  stage 3 (bf16 kernel, 256 queries, R=%d): %.3f ms, plain %.3f ms, conv1d %.3f "
          "ms, %s; vs plain max|dbest| %.2e, argoff ties %d  %s" % (
              eng.R, s3_ms, s3_plain_ms, s3_lib_ms, fmt_bound(s3_bound), err3, nbad3, card),
          flush=True)
    del eng, qd, qc8, db3, q3
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
    record("6: screened engine, int8 exact layout")
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
    f32 = screen_f32(dev, card, emb, counts, f, src, off, fn)
    # phase 10 serves the same batches sharded and holds it to these answers
    answers = dict(f=f, src=src, off=off, song=song, t=t, batch_ms=batch_ms, esc=esc_clean,
                   fn=fn, fsong=fsong, ft=ft, clear=clear, noisy_ms=noisy_ms)
    return {"max_abs_err": err8, "bf16_err": err3,
            "ms": s1_ms, "plain_ms": s1_plain_ms, "library_ms": s1_lib_ms,
            "bound": s1_bound, "corpus": (emb, counts), "f32": f32, "answers": answers}


def held_launch(name, db, q, R, S, n_songs, card, conv_reps=1):
    """The bf16 or f32 kernel at one main-path shape: held to the plain
    version on the same tensors (which also times it once), then timed (3
    calls), beside F.conv1d + amax with TF32 off and the bound.  Prints the
    form's largest |dbest| on a line of its own; returns the numbers."""
    form = {torch.float32: "f32", torch.bfloat16: "bf16"}[db.dtype]
    err, nbad, _, plain_ms = compare(db, q, R, S, n_songs)
    ms = time_ms(lambda: align_reduce(db, q, R, S, n_songs), 3)
    lib_ms = conv_library_ms(db, q, R, S, n_songs, conv_reps)
    bnd = bound(db.dtype, db.shape[0], db.shape[1], S, q.shape[0], n_songs, R)
    print("  %s kernel, %s (R=%d, S=%d, B=%d, %d songs): %.3f ms, plain %.3f ms, conv1d "
          "%.3f ms, %s; argoff ties %d  %s" % (form, name, R, S, q.shape[0], n_songs, ms,
                                               plain_ms, lib_ms, fmt_bound(bnd), nbad, card),
          flush=True)
    print("  %s max|dbest| %s: %.3e" % (form, name, err), flush=True)
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound": bnd}


def screen_f32(dev, card, emb, counts, f, src, off, fn):
    """Phase 6, db_dtype float32: the screened engine with an f32 exact
    layout and (by default) an f32 stage 1.  (f2) the 1,024 clean queries,
    recall 1024/1024, and stage 1 alone; (f3) the 256 noisy ones, which
    escalate to the f32 rescue over the whole exact layout, equal to the
    exhaustive f32 engine where its margin is clear, and stage 3 alone."""
    B, S, d = f.shape
    k = 4
    tm = time.time()
    eng = ScreenedAlignmentEngine(emb, counts, pad=32, k=k, top_m=32,
                                  score_dtype=torch.float32, device=dev,
                                  rescue_threshold=0.4)
    torch.cuda.synchronize()
    if eng.coarse_dtype != torch.float32:
        raise AssertionError("f32 engine: stage 1 in %s" % eng.coarse_dtype)
    print("  f32 screened engine: build %.1f s, resident %.1f MB (f32 exact layout %.1f MB + "
          "f32 coarse copy %.1f MB)  %s" % (
              time.time() - tm, eng.resident_bytes() / 1e6, eng._db3.numel() * 4 / 1e6,
              eng._coarse.numel() * 4 / 1e6, card), flush=True)
    out = {}
    reset_launch_counts()
    song, _, t = eng.search_top1(f)
    torch.cuda.synchronize()
    n = record("6: f32 screened engine, clean batch")
    hits, right = int((song == src).sum()), int((t == off).sum())
    if hits != B or right != B or n["f32"] < 1 or n["bf16"] or n["int8"]:
        raise AssertionError("f32 screened clean batch: recall %d/%d, offsets %d/%d, "
                             "launches %s" % (hits, B, right, B, n))
    batch_ms = time_ms(lambda: eng.search_top1(f), 3)
    print("  (f2) clean batch: recall %d/%d, offsets right %d/%d, f32 launches %d; "
          "search_top1 %.4f s/batch = %.1f queries/s  %s" % (
              hits, B, right, B, n["f32"], batch_ms / 1e3, B / (batch_ms / 1e3), card),
          flush=True)
    qc = collapse_queries(torch.from_numpy(f).to(dev), k)
    out["f2"] = held_launch("f2 stage 1", eng._coarse, qc, eng.Rc, qc.shape[1], eng.n_pad,
                            card)
    del qc

    reset_launch_counts()
    esc0 = eng.escalated
    song_n, _, t_n = eng.search_top1(fn)
    torch.cuda.synchronize()
    n = record("6: f32 screened engine, noisy batch")
    esc = eng.escalated - esc0
    if esc < 1 or n["f32"] < 2 or n["bf16"] or n["int8"]:
        raise AssertionError("f32 noisy batch: escalated %d, launches %s" % (esc, n))
    noisy_ms = time_ms(lambda: eng.search_top1(fn), 1)
    db3 = eng._db3.view(-1, d)
    q3 = torch.from_numpy(fn).to(dev)
    out["f3"] = held_launch("f3 stage 3", db3, q3, eng.R, S, eng.n_pad, card)
    del eng, db3, q3
    torch.cuda.empty_cache()
    full = AlignmentEngine(emb, counts, score_dtype=torch.float32, device=dev)
    (fb, fo), = full.search_device(fn)
    top2 = fb.topk(2, dim=1).values
    clear = ((top2[:, 0] - top2[:, 1]) > BEST_ATOL).cpu().numpy()
    fsong, _, ft = (x.cpu().numpy() for x in _top1(fb, fo, full.pad))
    same = (song_n == fsong) & (t_n == ft)
    if not same[clear].all() or not clear.any():
        raise AssertionError("(f3): %d answers differ from the exhaustive f32 engine's "
                             "where its margin is clear (%d clear)"
                             % (int((~same[clear]).sum()), int(clear.sum())))
    print("  (f3) noisy batch (256 queries): escalated %d, f32 launches %d, answers == "
          "exhaustive f32 engine on %d/%d with a clear margin (%d/256 equal in all); "
          "screened %.3f ms  %s" % (esc, n["f32"], int(same[clear].sum()), int(clear.sum()),
                                    int(same.sum()), noisy_ms, card), flush=True)
    del full, fb, fo
    torch.cuda.empty_cache()
    return out


def png_pixels(path):
    """The pixels [H, W, 3] uint8 of an 8-bit RGB PNG whose rows all use
    filter 0 (the port's writer), decoded with zlib."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError("%s is not a PNG" % path)
    chunks, pos = collections.defaultdict(bytes), 8
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos : pos + 8])
        chunks[kind] += data[pos + 8 : pos + 8 + n]
        pos += 12 + n
    w, h, depth, color = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8).reshape(h, 1 + 3 * w)
    if depth != 8 or color != 2 or raw[:, 0].any():
        raise AssertionError("%s: depth %d colour %d, filters %s"
                             % (path, depth, color, set(raw[:, 0].tolist())))
    return raw[:, 1:].reshape(h, w, 3)


def hold_to_native(db, queries, emb, song_pos, n=4):
    """The port's answers for queries[:n] against the native C++ core (f32
    on the host, independent of the port's engines) at the DB's top_k:
    the best mean score within MEAN_ATOL, song and time equal where the
    core's top-1 margin exceeds it.  The core's queries run on n threads
    (ctypes releases the GIL).  Returns (#held, max |score diff|)."""
    queries = list(queries[:n])
    with concurrent.futures.ThreadPoolExecutor(n) as pool:
        natives = list(pool.map(lambda q: native.native_query(
            emb, song_pos, q, db.top_k, db.frame_shift_mul, db.score_alpha), queries))
    held, err = 0, 0.0
    scale = db.hop_size / db.frame_shift_mul
    for (score, (song, t), _), (best, table) in zip(db.query_embeddings_batch(queries),
                                                   natives):
        err = max(err, abs(score - float(table[best, 0])))
        if err > MEAN_ATOL:
            raise AssertionError("port %g vs native core %g" % (score, table[best, 0]))
        top2 = np.sort(table[:, 0])[-2:]
        if top2[1] - top2[0] > MEAN_ATOL:
            if (song, t) != (best, float(table[best, 1]) * scale):
                raise AssertionError("port (%d, %g) vs native core (%d, %g)" % (
                    song, t, best, table[best, 1] * scale))
            held += 1
    if held == 0:
        raise AssertionError("no query had a clear margin against the native core")
    return held, err


def rest_of_serving(dev, card, tmp, emb4, big, p5):
    """Phase 7: the long-query fallback, the topk engine, score_alpha and
    db_dtype float32 (f1) through Database on phase 4's corpus as a DB
    directory, score_alpha on the screened engine on phase 6's corpus, and
    the side CLIs and saliency on phase 5's DB (p5: its qlist, db_dir,
    default TSV, truth).  Returns the f32 kernel's numbers at (f1)."""
    phase(7, "the rest of serving: topk engine, long-query fallback, score_alpha, "
             "saliency, side CLIs")
    per, hop = 120, 0.5
    n_songs, d = emb4.shape[0] // per, emb4.shape[1]
    counts = np.full(n_songs, per, np.int32)
    song_pos = np.pad(np.cumsum(counts, dtype=np.int64), (1, 0))
    db_dir = os.path.join(tmp, "db10k")
    os.makedirs(db_dir)
    emb4.tofile(os.path.join(db_dir, "embeddings"))
    counts.tofile(os.path.join(db_dir, "landmarkKey"))
    with open(os.path.join(db_dir, "songList.txt"), "w") as fh:
        fh.writelines("song%05d.wav\n" % i for i in range(n_songs))
    write_index_meta(db_dir, d=d, meta={"ntotal": int(emb4.shape[0])})
    print("  DB directory: %d songs x %d rows, d=%d, %.3f GB of f32 embeddings" % (
        n_songs, per, d, emb4.nbytes / 1e9), flush=True)

    def crops(corpus, seed, n, S, noise=0.1):
        """n noisy self-crops of S rows, renormalised; (queries, song, row)."""
        r = np.random.default_rng(seed)
        n_s = corpus.shape[0] // per
        src, off = r.integers(0, n_s, size=n), r.integers(0, per - S + 1, size=n)
        q = corpus[(src * per + off)[:, None] + np.arange(S)]
        q += noise * r.standard_normal(q.shape, dtype=np.float32)
        q /= np.linalg.norm(q, axis=2, keepdims=True)
        return q, src, off

    def serve(params, queries, src, off, path, launches=None, db=None):
        """Database(params).query_top1_batch (on ``db`` where given): once
        with the launch counts at 0 (recall, offsets; the launches must be
        ``launches``, default none), then once timed.  Returns (db, ms)."""
        db = db or Database(db_dir, params, hop, dev)
        qs = list(queries)
        reset_launch_counts()
        ans = db.query_top1_batch(qs)
        torch.cuda.synchronize()
        n = record(path)
        if n != (launches or dict.fromkeys(n, 0)):
            raise AssertionError("%s launched align_reduce: %s" % (path, n))
        song = np.array([a[1][0] for a in ans])
        t = np.array([a[1][1] for a in ans])
        hits, right = int((song == src).sum()), int((t == off * hop).sum())
        if hits != len(qs) or right != len(qs):
            raise AssertionError("%s: recall %d/%d, offsets %d/%d"
                                 % (path, hits, len(qs), right, len(qs)))
        tm = time.perf_counter()
        db.query_top1_batch(qs)
        torch.cuda.synchronize()
        return db, (time.perf_counter() - tm) * 1e3

    # (a) 60 s MIREX queries (119 rows at a 0.5 s hop) on the align engine
    # at pad 32: the topk fallback
    qa, src, off = crops(emb4, 71, 32, 119)
    db, ms_a = serve({"top_k": 100}, qa, src, off, "7a: long-query fallback, align pad 32")
    if db.engine != "align":
        raise AssertionError("7a served by the %s engine" % db.engine)
    held, err = hold_to_native(db, qa, emb4, song_pos)
    print("  (a) 32 queries of 119 rows, align engine at pad 32 -> topk fallback "
          "(top_k 100): recall 32/32, offsets 32/32, align_reduce launches 0; "
          "%.3f ms per 32 queries; == native C++ core on %d/4 (max |dscore| %.2e)  %s"
          % (ms_a, held, err, card), flush=True)
    del db
    torch.cuda.empty_cache()

    # (b) engine: topk on 10 s queries
    qb, src, off = crops(emb4, 72, 32, 19)
    db, ms_b = serve({"top_k": 100, "engine": "topk"}, qb, src, off, "7b: engine topk")
    held, err = hold_to_native(db, qb, emb4, song_pos)
    print("  (b) engine topk, top_k 100, 32 queries of 19 rows: recall 32/32, "
          "align_reduce launches 0; %.3f ms per 32 queries; == native C++ core on "
          "%d/4 (max |dscore| %.2e)  %s" % (ms_b, held, err, card), flush=True)
    del db
    torch.cuda.empty_cache()

    # (c) score_alpha 1.0 on the exhaustive engine
    qc, src, off = crops(emb4, 73, 256, 19)
    db, ms_c = serve({"top_k": 100, "score_alpha": 1.0}, qc, src, off,
                     "7c: score_alpha 1.0, exhaustive engine")
    del db
    torch.cuda.empty_cache()
    # held to the CPU alpha path on 1,000 songs of the same DB, for the
    # first 128 queries (the CPU side's time grows with both)
    tm = time.perf_counter()
    n_cpu, qh = min(1000, n_songs), qc[:128]
    eng = {dv: AlignmentEngine(emb4[: n_cpu * per], counts[:n_cpu], score_dtype=torch.bfloat16,
                               device=dv, score_alpha=1.0) for dv in (dev, "cpu")}
    (gb, go), = eng[dev].search_device(qh)
    (cb, co), = eng["cpu"].search_device(qh)
    cpu_s = time.perf_counter() - tm
    err_c = float((gb.cpu() - cb).abs().max())
    if err_c > BEST_ATOL:
        raise AssertionError("alpha path: card vs CPU max|dbest| %g" % err_c)
    bad = (go.cpu() != co).nonzero().numpy()
    if len(bad):
        b, s = bad[:, 0], bad[:, 1]
        qd = torch.from_numpy(qh).to(dev, torch.bfloat16)
        e = eng[dev]
        a = exact_scores(e._db, qd, e.R, 19, np.stack([b, s, go.cpu().numpy()[b, s]], 1),
                         alpha=1.0, row_valid=e._row_valid)
        p = exact_scores(e._db, qd, e.R, 19, np.stack([b, s, co.numpy()[b, s]], 1),
                         alpha=1.0, row_valid=e._row_valid)
        if np.abs(a - p).max() > BEST_ATOL:
            raise AssertionError("alpha path: argoff differs where the margin exceeds %g"
                                 % BEST_ATOL)
    print("  (c) score_alpha 1.0, exhaustive engine, 256 queries of 19 rows: recall "
          "256/256, align_reduce launches 0; %.3f ms per 256 queries; card == CPU alpha "
          "path on %d songs x 128 queries (max|dbest| %.2e, argoff ties %d; CPU side %.1f s)  %s"
          % (ms_c, n_cpu, err_c, len(bad), cpu_s, card), flush=True)
    del eng, gb, go
    torch.cuda.empty_cache()

    # (f1) db_dtype float32 on the exhaustive engine: the f32 kernel at
    # full width, one launch per batch, held to its plain version and timed
    # on the filters the Database's top-1 path launches (19 windows)
    qf, src, off = crops(emb4, 75, 1024, 19)
    f32 = {}
    db = None
    for B in (1024, 32):
        path = "7f1: db_dtype float32, exhaustive engine, B=%d" % B
        db, ms_f = serve({"top_k": 100, "db_dtype": "float32"}, qf[:B], src[:B], off[:B],
                         path, launches={"bf16": 0, "f32": 1, "int8": 0}, db=db)
        e = db._align
        if db.engine != "align" or e._db.dtype != torch.float32:
            raise AssertionError("(f1) served by %s in %s" % (db.engine, e._db.dtype))
        print("  (f1) db_dtype float32, exhaustive engine (%.1f MB resident), %d noisy "
              "queries: recall %d/%d, offsets %d/%d, f32 launches 1; %.3f ms per batch  %s"
              % (e._db.numel() * 4 / 1e6, B, B, B, B, B, ms_f, card), flush=True)
        filters, _ = db._filters(list(qf[:B]), bucket=False)
        q = torch.from_numpy(filters).to(dev)
        f32[B] = held_launch("f1 B=%d" % B, e._db, q, e.R, q.shape[1], e.n_songs, card,
                             conv_reps=3)
        del q
    del db, e
    torch.cuda.empty_cache()

    # (d) score_alpha 1.0 on the screened engine, phase 6's corpus
    emb, counts100 = big
    qd, src, off = crops(emb, 74, 256, 19)
    tm = time.perf_counter()
    eng = ScreenedAlignmentEngine(emb, counts100, pad=32, k=4, top_m=32,
                                  score_dtype=torch.bfloat16, coarse_dtype="int8",
                                  device=dev, rescue_threshold=0.4, score_alpha=1.0)
    build_s = time.perf_counter() - tm
    reset_launch_counts()
    song, _, t = eng.search_top1(qd)
    torch.cuda.synchronize()
    n = record("7d: score_alpha 1.0, screened engine")
    hits, right = int((song == src).sum()), int((t == off).sum())
    if hits != 256 or right != 256 or n["int8"] < 1 or n["bf16"] or n["f32"]:
        raise AssertionError("7d: recall %d/256, offsets %d/256, launches %s"
                             % (hits, right, n))
    ms_d = time_ms(lambda: eng.search_top1(qd), 3)
    del eng
    torch.cuda.empty_cache()
    full = AlignmentEngine(emb, counts100, score_dtype=torch.bfloat16, device=dev,
                           score_alpha=1.0)
    reset_launch_counts()
    tm = time.perf_counter()
    (fb, fo), = full.search_device(qd)
    torch.cuda.synchronize()
    full_ms = (time.perf_counter() - tm) * 1e3
    record("7d: score_alpha 1.0, exhaustive engine at 100k songs")
    top2 = fb.topk(2, dim=1).values
    clear = ((top2[:, 0] - top2[:, 1]) > BEST_ATOL).cpu().numpy()
    fsong, _, ft = (x.cpu().numpy() for x in _top1(fb, fo, full.pad))
    same = (song == fsong) & (t == ft)
    if not same[clear].all() or not clear.any():
        raise AssertionError("7d: %d answers differ from the exhaustive alpha engine's "
                             "where its margin is clear (%d clear)"
                             % (int((~same[clear]).sum()), int(clear.sum())))
    print("  (d) score_alpha 1.0, screened engine at %d songs (build %.1f s), 256 clean "
          "queries: recall 256/256, int8 launches %d, bf16 0; %.3f ms per 256 queries; "
          "== the exhaustive alpha engine on %d/%d with a clear margin (it takes "
          "%.3f ms)  %s" % (len(counts100), build_s, n["int8"], ms_d, int(same[clear].sum()),
                             int(clear.sum()), full_ms, card), flush=True)
    del full, fb, fo
    torch.cuda.empty_cache()

    # (e) the side CLIs and saliency on phase 5's DB, back on the align engine
    qlist, p5db, want = p5["qlist"], p5["db_dir"], open(p5["tsv"], "rb").read()
    cfg_path = os.path.join(p5db, "configs.json")
    out = os.path.join(tmp, "out7")

    def set_screen(on):
        with open(cfg_path) as fh:
            params = json.load(fh)
        params["indexer"]["screen"] = on
        with open(cfg_path, "w") as fh:
            json.dump(params, fh, indent=2)
        return params

    def run(path, fn, argv, tsv=None):
        reset_launch_counts()
        tm = time.perf_counter()
        fn([fn.__module__.rsplit(".", 1)[-1], *argv])
        torch.cuda.synchronize()
        sec = time.perf_counter() - tm
        n = record(path)
        if tsv is not None and open(tsv, "rb").read() != want:
            raise AssertionError("%s: TSV differs from phase 5's matcher TSV" % path)
        return sec, n

    params = set_screen(False)
    viz = os.path.join(out, "viz", "result.txt")
    viz_s, _ = run("7e: matcher --visualize", matcher.main,
                   [qlist, p5db, viz, "--visualize", "--device", "cuda"], tsv=viz)
    embedder = Embedder(params, os.path.join(p5db, "model.msgpack"), dev)
    queries = list(MusicDataset(qlist, params))
    for _, name, segs in queries:
        img = png_pixels(os.path.join(os.path.dirname(viz), os.path.basename(name) + ".png"))
        want_shape = (embedder.model.F, segs.shape[0] * embedder.model.T, 3)
        if img.shape != want_shape or not img.any():
            raise AssertionError("%s.png: %s, saliency_image %s" % (name, img.shape, want_shape))
    sal_dir = os.path.join(out, "saliency")
    os.makedirs(sal_dir)
    embedder.embed_with_saliency(queries[0][2])  # warm-up
    tm = time.perf_counter()
    for _, name, segs in queries:
        _, grads, specs = embedder.embed_with_saliency(segs)
        save_saliency_png(sal_dir, name, grads, specs)
    sal_ms = (time.perf_counter() - tm) * 1e3 / len(queries)
    print("  matcher --visualize: %d PNGs decode to saliency_image's shape %s, TSV == the "
          "default mode's (%.2f s); saliency %.3f ms per query of %d segments  %s" % (
              len(queries), want_shape, viz_s, sal_ms, queries[0][2].shape[0], card),
          flush=True)

    emb_dir = os.path.join(out, "qemb")
    run("7e: extractemb", extractemb.main, [qlist, p5db, emb_dir, "--device", "cuda"])
    res = os.path.join(out, "matchemb_align.txt")
    _, n_align = run("7e: matchemb, align engine", matchemb.main,
                     [emb_dir, p5db, res, "--device", "cuda"], tsv=res)
    set_screen(True)
    res = os.path.join(out, "matchemb_screen.txt")
    _, n_screen = run("7e: matchemb, screened engine", matchemb.main,
                      [emb_dir, p5db, res, "--device", "cuda"], tsv=res)
    set_screen(False)
    rebuild.main(["rebuild", p5db])
    res = os.path.join(out, "rebuilt.txt")
    run("7e: matcher after rebuild", matcher.main, [qlist, p5db, res, "--device", "cuda"],
        tsv=res)
    print("  extractemb -> matchemb TSVs == matcher's (align engine: %d bf16 launches; "
          "screen: true: %d int8); rebuild, then matcher: the same TSV" % (
              n_align["bf16"], n_screen["int8"]), flush=True)

    gt = os.path.join(out, "gt.tsv")
    with open(gt, "w") as fh:
        fh.writelines("%s\t%s\n" % (os.path.splitext(os.path.basename(q))[0],
                                    os.path.splitext(os.path.basename(s))[0])
                      for q, s, _ in p5["truth"])
    res = os.path.join(out, "fromgt.csv")
    run("7e: matchfromgt", matchfromgt.main, [qlist, gt, p5db, res, "--device", "cuda"])
    with open(res) as fh:
        rows = list(csv.reader(fh))[1:]
    got = [(r[0], r[1], float(r[3])) for r in rows]
    if got != [tuple(x) for x in p5["truth"]]:
        raise AssertionError("matchfromgt: %s" % got[:4])
    res = os.path.join(out, "cpp.txt")
    cpp_s, _ = run("7e: cppmatcher", cppmatcher.main, [qlist, p5db, res, "--device", "cuda"])
    with open(res) as fh:
        answers = [ln.rstrip("\n").split("\t")[1] for ln in fh]
    hits = sum(a == s for a, (_, s, _) in zip(answers, p5["truth"]))
    if hits != len(p5["truth"]):
        raise AssertionError("cppmatcher recall %d/%d" % (hits, len(p5["truth"])))
    print("  matchfromgt: %d rows, answers and times == the crops' (hop-aligned); "
          "cppmatcher (native matcher binary): recall %d/%d (%.2f s)  %s" % (
              len(rows), hits, len(p5["truth"]), cpp_s, card), flush=True)
    return f32


def lm_song(seed, n, sr=8000):
    """bench.py's landmark song (bench.py:811-824): decaying tone bursts
    over a noise floor, int16-quantised as a decoded WAV."""
    r = np.random.default_rng(seed)
    out = 0.01 * r.standard_normal(n).astype(np.float32)
    t = 0
    while t < n:
        dur = min(int(sr * r.uniform(0.1, 0.4)), n - t)
        tt = np.arange(dur, dtype=np.float32) / sr
        tone = np.sin(2 * np.pi * r.uniform(100, 3500) * tt)
        out[t : t + dur] += (r.uniform(0.3, 0.8) * tone * np.exp(-tt * 20)).astype(np.float32)
        t += dur + int(sr * r.uniform(0.05, 0.2))
    out = 0.6 * out / max(float(np.abs(out).max()), 1e-9)
    return (np.clip(out, -1, 1) * 32767).astype(np.int16)


def hash_agreement(a_pairs, b_pairs):
    """bench.py's landmark agreement: shared (hash, anchor) pairs over the
    larger set, summed over songs."""
    agree = total = 0
    for (ha, ta), (hb, tb) in zip(a_pairs, b_pairs):
        a, b = set(zip(ha.tolist(), ta.tolist())), set(zip(hb.tolist(), tb.tolist()))
        agree += len(a & b)
        total += max(len(a), len(b), 1)
    return agree / max(total, 1)


def flips_in_noise(wav, card_peaks, plain_peaks, tol=1e-3):
    """Peaks of one song where the card and the plain version (the same
    torch code on the CPU) differ, and how many of them lie within ``tol``
    (log units) of the median gate or of a neighbour's value in their
    local-max window, by the plain version's spectrum."""
    a, b = set(map(tuple, card_peaks.tolist())), set(map(tuple, plain_peaks.tolist()))
    diff = sorted(a ^ b)
    if not diff:
        return 0, 0
    nf = 1 + (max(len(wav), lm_core.N_FFT) - lm_core.N_FFT) // lm_core.HOP
    buf, _ = DevicePeakExtractor(device="cpu").stage_chunk([(0, wav, nf)])
    spec = log_spectrogram(buf)[0, :nf].numpy().T  # [F, T]
    gate = np.median(spec) + lm_core.MIN_GAIN
    noisy = 0
    for f, t in diff:
        win = spec[max(f - lm_core.NEIGH_F // 2, 0) : f + lm_core.NEIGH_F // 2 + 1,
                   max(t - lm_core.NEIGH_T // 2, 0) : t + lm_core.NEIGH_T // 2 + 1]
        others = np.sort(win.ravel())[::-1]
        tie = abs(others[0] - others[1]) <= tol and spec[f, t] >= others[1]
        noisy += bool(abs(spec[f, t] - gate) <= tol or tie)
    return len(diff), noisy


def landmark_front_end(dev, card, tmp, p5, n_songs=256):
    """Phase 8: the landmark front end.  (a) DevicePeakExtractor (batch 32,
    pipeline 4) on n_songs x 30 s of bench.py's landmark songs against the
    numpy host path (hash agreement >= 0.999, audio-s/s of both), and on 8
    of them against the same torch code on the CPU; (b) lm_builder and
    lm_matcher on phase 5's corpus and crops (p5: lst, qlist, truth), with
    the card extractor and with PFANN_LM_DEVICE=0.  Every landmark path
    must launch no align-reduce kernel."""
    phase(8, "the landmark front end: DevicePeakExtractor on the card, lm_builder + "
             "lm_matcher")
    sr, seconds = 8000, 30.0
    n = int(sr * seconds)
    tm = time.perf_counter()
    wavs = [lm_song(i, n) for i in range(n_songs)]
    dev_in = [as_device_input(w.astype(np.float32) / 32768) for w in wavs]
    if any(w.dtype != np.int16 for w in dev_in):
        raise AssertionError("8a: the decoded-WAV songs do not ride as int16")
    print("  corpus: %d songs x %.0f s at %d Hz, int16 (%.1f s to make)" % (
        n_songs, seconds, sr, time.perf_counter() - tm), flush=True)
    ex = DevicePeakExtractor(batch=32, pipeline=4, device=dev)
    # warm-up on distinct songs at the measured batch size
    ex.extract([lm_song(n_songs + i, n) for i in range(ex.batch)])
    torch.cuda.synchronize()
    reset_launch_counts()
    tm = time.perf_counter()
    card_peaks = ex.extract(dev_in)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - tm
    tm = time.perf_counter()
    card_hashes = [lm_core.pair_peaks(p) for p in card_peaks]
    t_pair = time.perf_counter() - tm
    launches = record("8a: DevicePeakExtractor, %d songs" % n_songs)
    if any(launches.values()):
        raise AssertionError("8a: the landmark front end launched align_reduce: %s" % launches)
    tm = time.perf_counter()
    host_hashes = [lm_core.extract_hashes(w.astype(np.float32) / 32768) for w in wavs]
    t_host = time.perf_counter() - tm
    agree = hash_agreement(host_hashes, card_hashes)
    audio_s = n_songs * seconds
    n_peaks = sum(len(p) for p in card_peaks)
    print("  card extractor: %.3f s for %.0f audio-s = %.1f audio-s/s (peaks); with host "
          "pairing %.3f s = %.1f audio-s/s; numpy host path (core.extract_hashes) %.3f s = "
          "%.1f audio-s/s; %d peaks, %d hashes; hash agreement with the host path %.6f  %s" % (
              t_card, audio_s, audio_s / t_card, t_card + t_pair, audio_s / (t_card + t_pair),
              t_host, audio_s / t_host, n_peaks, sum(len(h) for h, _ in card_hashes), agree,
              card), flush=True)
    if agree < 0.999:
        raise AssertionError("8a: hash agreement %.6f < 0.999" % agree)
    # the device share: peak_mask alone on one staged chunk of 32 songs
    chunk = [(i, w, 1 + (n - lm_core.N_FFT) // lm_core.HOP) for i, w in enumerate(dev_in[:32])]
    buf, valid = (x.to(dev) for x in ex.stage_chunk(chunk))
    mask_ms = time_ms(lambda: peak_mask(buf, valid), 5)
    T = buf.shape[1] // lm_core.HOP - (lm_core.N_FFT // lm_core.HOP - 1)
    moved = buf.numel() * buf.element_size() + 32 * (lm_core.N_FFT // 2 + 1) * -(-T // 8)
    print("  peak_mask alone: %.3f ms per chunk of 32 songs (%.1f audio-s/s of device time; "
          "%d chunks = %.3f s of the extractor's %.3f s); the int16 in and the packed mask "
          "out move %.1f MB, %.4f ms at 3.35 TB/s  %s" % (
              mask_ms, 32 * seconds / (mask_ms / 1e3), -(-n_songs // 32),
              -(-n_songs // 32) * mask_ms / 1e3, t_card, moved / 1e6,
              moved / HBM_BYTES_S * 1e3, card), flush=True)
    del buf, valid
    # the card against its plain version: the same torch code on the CPU
    tm = time.perf_counter()
    plain = DevicePeakExtractor(batch=8, device="cpu").extract(dev_in[:8])
    plain_s = time.perf_counter() - tm
    n_diff = n_noise = 0
    for w, c, p in zip(dev_in[:8], card_peaks[:8], plain):
        d, z = flips_in_noise(w, c, p)
        n_diff += d
        n_noise += z
    print("  card vs the same torch code on the CPU (8 songs, %.3f s there): %d of %d peaks "
          "differ, %d of them within 1e-3 of the gate or of a window tie  %s" % (
              plain_s, n_diff, sum(len(p) for p in plain), n_noise, card), flush=True)
    if n_diff != n_noise:
        raise AssertionError("8a: %d peaks differ from the plain version away from the "
                             "gate and from ties" % (n_diff - n_noise))

    # (b) the CLIs on phase 5's corpus and crops
    out = os.path.join(tmp, "out8")
    runs = {}
    for tag, env in (("card extractor", None), ("PFANN_LM_DEVICE=0", "0")):
        db_dir = os.path.join(out, tag.split()[0].split("=")[0].lower() + "_db")
        res = os.path.join(out, os.path.basename(db_dir)[:-3] + "_result.txt")
        os.makedirs(out, exist_ok=True)
        if env is not None:
            os.environ["PFANN_LM_DEVICE"] = env
        try:
            secs = []
            for name, fn, argv in (("lm_builder", lm_builder.main, [p5["lst"], db_dir]),
                                   ("lm_matcher", lm_matcher.main, [p5["qlist"], db_dir, res])):
                reset_launch_counts()
                tm = time.perf_counter()
                fn([name, *argv, "--device", dev.type])
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - tm)
                n = record("8b: %s, %s" % (name, tag))
                if any(n.values()):
                    raise AssertionError("8b: %s launched align_reduce: %s" % (name, n))
        finally:
            os.environ.pop("PFANN_LM_DEVICE", None)
        runs[tag] = (db_dir, res, secs)
    (cdb, cres, csecs), (hdb, hres, hsecs) = runs["card extractor"], runs["PFANN_LM_DEVICE=0"]
    answers = [ln.rstrip("\n").split("\t")[1] for ln in open(cres)]
    hits = sum(a == s for a, (_, s, _) in zip(answers, p5["truth"]))
    if hits != len(p5["truth"]):
        raise AssertionError("8b: landmark recall %d/%d" % (hits, len(p5["truth"])))
    if open(cres, "rb").read() != open(hres, "rb").read():
        raise AssertionError("8b: the card extractor's TSV differs from the host path's")
    cbin, hbin = (np.fromfile(r + ".bin", np.int32) for r in (cres, hres))
    n_db = len(read_file_list(p5["lst"]))
    if cbin.shape != hbin.shape or cbin.size != len(p5["truth"]) * n_db * 2:
        raise AssertionError("8b: .bin holds %d and %d int32" % (cbin.size, hbin.size))
    triples = []
    for db_dir in (cdb, hdb):
        with np.load(os.path.join(db_dir, "landmarks.npz")) as z:
            triples.append(set(zip(*(z[k].tolist() for k in ("hashes", "songs", "anchors")))))
    db_agree = len(triples[0] & triples[1]) / max(len(triples[0]), len(triples[1]), 1)
    print("  lm_builder %.2f s + lm_matcher %.2f s on the card (phase 5's %d songs, %d crops); "
          "PFANN_LM_DEVICE=0: %.2f s + %.2f s; recall %d/%d; TSV == the host path's; .bin "
          "entries differing %d of %d; index triples agreeing %.6f; align-reduce launches 0  "
          "%s" % (csecs[0], csecs[1], n_db, len(p5["truth"]), hsecs[0], hsecs[1], hits,
                  len(p5["truth"]), int((cbin != hbin).sum()), cbin.size, db_agree, card),
          flush=True)


def fwd_flops_per_row(model):
    """Forward operations of one row through FpNetwork: 2 x the multiply-
    adds of every conv (output volume x input channels per group x kernel)
    and of the projector's two grouped einsums."""
    total = 0
    for block in model.f.blocks:
        for conv, ln in ((block.conv1, block.ln1), (block.conv2, block.ln2)):
            c_out, f_out, t_out = ln.shape
            kh, kw = conv.kernel_size
            total += 2 * c_out * f_out * t_out * (conv.in_channels // conv.groups) * kh * kw
    d, v, u = model.g.w1.shape
    return total + 2 * d * (v * u + u)


def grad_norm(model):
    return float(torch.sqrt(sum((p.grad.double() ** 2).sum() for p in model.parameters())))


def step_timing(tr, rows, dev, reps=8):
    """(ms per train step by CUDA events over ``reps`` distinct batches
    after two warm-up steps, first step's loss, global grad norm after it,
    peak MB, optimizer.step alone in ms)."""
    F, T = tr.model.F, tr.model.T
    g = torch.Generator(device=dev).manual_seed(rows)
    xs = [torch.randn(rows, F, T, device=dev, generator=g) * 2 - 4 for _ in range(reps + 2)]
    draws = [tr.specaug.draw(seeded_generator(123, rows, i), F, T) for i in range(reps + 2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    first = float(tr.train_step(xs[0], draws[0]))
    gnorm = grad_norm(tr.model)
    tr.train_step(xs[1], draws[1])
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    losses = [tr.train_step(xs[i + 2], draws[i + 2]) for i in range(reps)]
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    peak_mb = torch.cuda.max_memory_allocated(dev) / 2**20
    if not (np.isfinite(first) and np.isfinite(gnorm)
            and torch.isfinite(torch.stack(losses)).all()):
        raise AssertionError("9a: non-finite loss or grads at %d rows" % rows)
    opt_ms = time_ms(tr.optimizer.step, reps)
    del xs
    return ms, first, gnorm, peak_mb, opt_ms


def profile_steps(tr, rows, dev, n=2):
    """torch.profiler over ``n`` warm train steps: (the device's busy share
    of their wall time, [(kernel, device ms a step)] for the top kernels)."""
    from torch.profiler import ProfilerActivity, profile

    F, T = tr.model.F, tr.model.T
    xs = [torch.randn(rows, F, T, device=dev) * 2 - 4 for _ in range(n)]
    draws = [tr.specaug.draw(seeded_generator(7, rows, i), F, T) for i in range(n)]
    tr.train_step(xs[0], draws[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tm = time.perf_counter()
        for x, d in zip(xs, draws):
            tr.train_step(x, d)
        torch.cuda.synchronize()
        wall = time.perf_counter() - tm
    # kernels only: an op's row repeats the time of the kernels it launched
    kernels = [(e.key, e.self_device_time_total) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(t for _, t in kernels) / 1e6 / wall
    top = sorted(((k, t / 1e3 / n) for k, t in kernels), key=lambda kv: -kv[1])
    return busy, top[:10]


def f32_step_parity(cfg, dev, card):
    """One f32 step (TF32 off) at full width on 32 rows, the card against
    the CPU on the same params, batch and mask; with the flagship's ReLU
    and with ELU.  A ReLU input within rounding of 0 can take the other
    side of the kink on the other device and drop or keep its whole
    gradient (on an H100 one such input moved the gradient of every
    layer below it by ~0.6%), so ReLU is held loosely and ELU,
    whose derivative is continuous, tightly."""
    x = torch.from_numpy((np.random.default_rng(11).standard_normal((32, 256, 32)) * 2 - 4)
                         .astype(np.float32))
    lr = cfg["lr"]
    # (grad L2 rel, share of params within 1e-3 lr after the Adam step)
    gates = {"ReLU": (2e-2, 0.99), "ELU": (1e-4, 0.999)}
    for act, (grad_gate, share_gate) in gates.items():
        c = dict(cfg, model=dict(cfg["model"], conv_activation=act))
        out = {}
        for d in (torch.device("cpu"), dev):
            tr = Trainer(c, compute_dtype=torch.float32, device=d)
            tr.init_state(seed=5)
            loss = tr.train_step(x.to(d), tr.specaug.draw(seeded_generator(123, 0, 0), 256, 32))
            out[d.type] = (float(loss), [p.grad.cpu().double() for p in tr.model.parameters()],
                           [p.detach().cpu() for p in tr.model.parameters()])
            del tr
        (lc, gc, pc), (lg, gg, pg) = out["cpu"], out[dev.type]
        loss_rel = abs(lg / lc - 1)
        grad_rel = float(torch.sqrt(sum(((a - b) ** 2).sum() for a, b in zip(gg, gc)))
                         / torch.sqrt(sum((b ** 2).sum() for b in gc)))
        diff = torch.cat([(a - b).abs().flatten() for a, b in zip(pg, pc)])
        share = float((diff <= 1e-3 * lr).float().mean())
        print("  9a f32 step (%s), card vs CPU, 32 rows at full width, TF32 off: loss %.7f vs "
              "%.7f (rel %.2e), grad L2 rel %.2e, params after the Adam step within 1e-3 lr "
              "on %.6f of entries (max |dp| %.3f lr)  %s" % (
                  act, lg, lc, loss_rel, grad_rel, share, float(diff.max()) / lr, card),
              flush=True)
        if loss_rel > 1e-5 or grad_rel > grad_gate or share < share_gate:
            raise AssertionError("9a: the card's f32 %s step differs from the CPU's" % act)


def train_cli(argv, cwd, timeout):
    """python -m pfann_tpu_torch.train in a child process; its stdout."""
    r = subprocess.run([sys.executable, "-m", "pfann_tpu_torch.train"] + argv, cwd=cwd,
                       env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
                       text=True, timeout=timeout)
    if r.returncode:
        raise AssertionError("train CLI exited %d: %s" % (r.returncode, r.stderr[-3000:]))
    return r.stdout


def epoch_metrics(model_dir):
    """{(tag, epoch): value} from the trainer's metrics.jsonl."""
    with open(os.path.join(model_dir, "metrics.jsonl")) as fh:
        rows = [json.loads(ln) for ln in fh]
    return {(r["tag"], r["step"]): r["value"] for r in rows}


def training_on_card(dev, card, tmp, model=None, rows=(640, 1280), train_songs=60,
                     mock_sizes=(3200, 640)):
    """Phase 9: training on the card (no align-reduce kernel on its paths).
    (a) the flagship train step (bf16, Adam; and LAMB) at 640 and 1,280
    rows, and one f32 step against the CPU; (b) python -m
    pfann_tpu_torch.train for 2 epochs on a synthetic corpus with the real
    loader (noise, room IR, mic IR on the card), the checkpoint contract,
    export_model, then builder + matcher with the trained model; (c) where
    the time goes in epoch 2; (d) the --mock CLI at flagship width.  The
    keywords cut the run for a rehearsal on the CPU (``model`` replaces
    the flagship's widths; ``rows[0]`` is the rows of a batch_size step).
    Writes under ``tmp``; returns (b)'s training config (its synthetic
    corpus, for phase 10)."""
    phase(9, "training on the card: train step, python -m pfann_tpu_torch.train, "
             "builder + matcher with the trained model")
    with open(os.path.join(REPO, "configs", "default.json")) as fh:
        flagship = json.load(fh)
    if model is not None:
        flagship["model"] = model
    on = ["--device", dev.type]
    n0 = rows[0]

    # (a) ------------------------------------------------------------
    reset_launch_counts()
    tr = Trainer(flagship, compute_dtype=torch.bfloat16, device=dev)
    per_row = fwd_flops_per_row(tr.model)
    steps = {}  # rows -> (ms a step, optimizer.step ms)
    for n in rows:
        tr.init_state()  # each row count starts from the seed's weights
        ms, first, gnorm, peak, opt_ms = step_timing(tr, n, dev)
        flops = 3 * per_row * n
        steps[n] = (ms, opt_ms)
        print("  9a bf16 Adam step, %d rows: %.3f ms (optimizer.step alone %.3f ms); first "
              "loss %.4f vs log(n-1) %.4f; grad norm %.4e; peak %.0f MB; %.3f TFLOP a step "
              "(3 x %.4f GFLOP a row fwd), %.1f TFLOP/s, %.1f%% of the bf16 dense peak  %s" % (
                  n, ms, opt_ms, first, math.log(n - 1), gnorm, peak, flops / 1e12,
                  per_row / 1e9, flops / ms / 1e9, 100 * flops / ms / 1e9 / (PEAK_OPS[
                      torch.bfloat16] / 1e12), card), flush=True)
        if abs(first / math.log(n - 1) - 1) > 0.1:
            raise AssertionError("9a: first loss %.4f not within 10%% of log(n-1)" % first)
    busy, top = profile_steps(tr, n0, dev)
    print("  9a profile of 2 steps at %d rows (torch.profiler): device busy %.1f%% of the wall; "
          "device ms a step, top kernels: %s  %s" % (n0, 100 * busy, "; ".join(
              "%s %.3f" % (k[:60], t) for k, t in top), card), flush=True)
    del tr
    lamb = Trainer(dict(flagship, optimizer="lamb"), compute_dtype=torch.bfloat16, device=dev)
    lamb.init_state()
    ms, first, gnorm, peak, opt_ms = step_timing(lamb, n0, dev)
    print("  9a bf16 LAMB step, %d rows: %.3f ms (optimizer.step alone %.3f ms); first loss "
          "%.4f; grad norm %.4e  %s" % (n0, ms, opt_ms, first, gnorm, card), flush=True)
    del lamb
    torch.cuda.empty_cache()
    record("9a: train steps (Adam at %s rows, LAMB at %d)" % (rows, n0))
    f32_step_parity(flagship, dev, card)

    # (b) --------------------------------------------------------
    root = os.path.join(tmp, "synth")
    tm = time.perf_counter()
    make_synth_corpus.main(["make_synth_corpus", "--root", root, "--train-songs", str(train_songs),
                            "--val-songs", "10", "--db-songs", "0", "--test-songs", "16",
                            "--seconds", "30"])
    corpus_s = time.perf_counter() - tm
    lists = os.path.join(root, "lists")
    cfg = dict(flagship, batch_size=n0, epoch=2, cache_dir=os.path.join(tmp, "caches"),
               model_dir=os.path.join(tmp, "model"), music_dir=os.path.join(root, "music"),
               train_csv=os.path.join(lists, "music_train.csv"),
               validate_csv=os.path.join(lists, "music_val.csv"),
               test_csv=os.path.join(lists, "music_test.csv"))
    for name in ("noise", "air", "micirp"):
        cfg[name] = dict(flagship[name], dir=os.path.join(root, name),
                         train=os.path.join(lists, "%s_train.csv" % name),
                         validate=os.path.join(lists, "%s_val.csv" % name))
    cfg_path = os.path.join(tmp, "train.json")
    with open(cfg_path, "w") as fh:
        json.dump(cfg, fh, indent=2)
    md = cfg["model_dir"]
    tm = time.perf_counter()
    out = train_cli(["-p", cfg_path, "-w", "4"] + on, tmp, 900)
    train_s = time.perf_counter() - tm
    losses = [float(s.split()[0]) for s in out.split("loss: ")[1:]]
    top1 = [float(s.split()[0]) for s in out.split("validate score: ")[1:]]
    top10 = [float(s.split()[0]) for s in out.split("validate top10: ")[1:]]
    n_train = int(out.split("training data contains ")[1].split()[0])
    if len(losses) != 2 or not np.isfinite(losses).all() or len(top1) != 2:
        raise AssertionError("9b: epoch losses %s, top-1 %s" % (losses, top1))
    for name in ("checkpoint0.ckpt", "checkpoint1.ckpt", "epochs.txt", "date.txt",
                 "configs.json", "metrics.jsonl", "model.msgpack"):
        if not os.path.exists(os.path.join(md, name)):
            raise AssertionError("9b: model dir lacks " + name)
    if ckpt.last_epoch(md) != 1:
        raise AssertionError("9b: epochs.txt says %d" % ckpt.last_epoch(md))
    print("  9b corpus %.1f s (%d train + 10 val + 16 test songs x 30 s); train CLI "
          "%.1f s wall for 2 epochs of %d segments: losses %s, validation top-1 %s, "
          "top-10 %s  %s" % (corpus_s, train_songs, train_s, n_train, losses, top1, top10, card),
          flush=True)
    reset_launch_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train_main(["train", "-p", cfg_path, "-w", "4"] + on)
    if "This model has finished training!" not in buf.getvalue():
        raise AssertionError("9b: the rerun did not report a finished model")
    record("9b: train CLI rerun (finished model), in-process")

    # builder + matcher with the trained model
    test_songs = read_file_list(os.path.join(lists, "db.txt"))
    qdir = os.path.join(tmp, "queries")
    os.makedirs(qdir)
    rng = np.random.default_rng(9)
    truth = []
    for qi in range(16):
        s = test_songs[qi]
        wav, _ = get_audio(s)
        start = int(rng.integers(0, 40)) * 4000  # hop-aligned 10 s crops
        qpath = os.path.join(qdir, "q%02d.wav" % qi)
        write_wav(qpath, wav.mean(axis=0)[start : start + 80000], 8000)
        truth.append((qpath, s))
    qlist = os.path.join(tmp, "queries.txt")
    with open(qlist, "w") as fh:
        fh.writelines(q + "\n" for q, _ in truth)
    db_dir, res = os.path.join(tmp, "db"), os.path.join(tmp, "out", "result.txt")
    reset_launch_counts()
    builder.main(["builder", os.path.join(lists, "db.txt"), db_dir, md] + on)
    matcher.main(["matcher", qlist, db_dir, res] + on)
    torch.cuda.synchronize()
    lb = record("9b: builder + matcher, trained model")["bf16"]
    answers = [ln.split("\t")[1] for ln in open(res).read().splitlines()]
    hits = sum(a == s for a, (_, s) in zip(answers, truth))
    print("  9b builder + matcher with the trained model: recall %d/16 on clean "
          "hop-aligned crops, bf16 kernel launches %d  %s" % (hits, lb, card), flush=True)
    if hits != 16 or lb < 1:
        raise AssertionError("9b: recall %d/16, %d bf16 launches" % (hits, lb))
    export_model.main(["export_model", md, "0"])
    exported = ckpt.load_model(md)
    c0 = ckpt.load_checkpoint(md, 0)["params"]
    if sorted(exported) != sorted(c0) or not all(torch.equal(exported[n], c0[n])
                                                 for n in c0):
        raise AssertionError("9b: export_model's model.msgpack differs from checkpoint 0")
    print("  9b export_model <model dir> 0: model.msgpack == checkpoint0.ckpt params")

    # (c) where the time goes in epoch 2 (epoch 1 built the caches)
    m = epoch_metrics(md)
    ep = {k: m[("train/" + k, 1)] for k in ("epoch_s", "steps", "host_s", "dispatch_s")}
    ep["steps"] = int(ep["steps"])
    reset_launch_counts()
    loader = SegmentedDataLoader("train", cfg, num_workers=4, device=dev)
    ds = loader.dataset
    x_org, x_aug = (torch.from_numpy(x).to(dev) for x in ds.get_batch(
        list(range(n0 // 2)), False, np.random.default_rng(0)))
    k = iter(range(100))
    aug_ms = time_ms(lambda: loader.augment(
        x_org, x_aug, loader.augment.draw(seeded_generator(777, 9, next(k)), n0 // 2)), 8)
    record("9c: augment alone")
    producer = ep["host_s"] + ep["dispatch_s"]
    step_ms, opt_ms = steps[n0]
    card_s = ep["steps"] * (aug_ms + step_ms) / 1e3
    print("  9c epoch 2: %.3f s for %d steps, %.1f segments/s (2 x %d segments); loader "
          "host_s %.3f, dispatch_s %.3f, rest %.3f s; corpus on the card: %s; augment "
          "alone %.3f ms per %d-pair batch; card work per epoch ~%.3f s (steps x "
          "(augment + %d-row step))  %s" % (
              ep["epoch_s"], ep["steps"], 2 * n_train / ep["epoch_s"], n_train,
              ep["host_s"], ep["dispatch_s"], ep["epoch_s"] - producer,
              loader.corpus_dev is not None, aug_ms, n0 // 2, card_s, n0, card), flush=True)
    parts = {"augment": aug_ms, "forward/backward and mask": step_ms - opt_ms,
             "optimizer": opt_ms}
    pace = "the card" if card_s >= producer else "the host (loader producer)"
    print("  9c pace: %s (card ~%.3f s vs producer %.3f s of %.3f s); on the card per "
          "step: %s  %s" % (pace, card_s, producer, ep["epoch_s"], ", ".join(
              "%s %.3f ms" % kv for kv in parts.items()), card), flush=True)
    del loader, x_org, x_aug

    # (d) the --mock CLI at flagship width, in-process ------------
    mock_cfg = dict(flagship, batch_size=n0, epoch=1, mock_sizes=list(mock_sizes),
                    model_dir=os.path.join(tmp, "mock_model"))
    mock_path = os.path.join(tmp, "mock.json")
    with open(mock_path, "w") as fh:
        json.dump(mock_cfg, fh)
    reset_launch_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        train_main(["train", "-p", mock_path, "--mock", "-w", "0"] + on)
    record("9d: train CLI --mock, in-process")
    m = epoch_metrics(mock_cfg["model_dir"])
    mock_ms = m[("train/epoch_s", 0)] / m[("train/steps", 0)] * 1e3
    print("  9d --mock, %d rows a step: %.3f ms a step over %d steps (host "
          "batches, loss %.4f)  %s" % (n0, mock_ms, m[("train/steps", 0)],
                                       m[("train/loss", 0)], card), flush=True)
    for path in [p for p in PATHS if p.startswith("9") and "matcher" not in p]:
        if any(PATHS[path].values()):
            raise AssertionError("%s launched the align-reduce kernel" % path)
    torch.cuda.empty_cache()
    return cfg


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def dp_step_rank(rank, world, port, cases, dev_name, out, reps):
    """The ranks of phase 10 (c), one process each: gloo ranks on the one
    card (CUDA tensors; NCCL refuses two ranks on one card).  For each
    case (cfg, dtype, x, draws), the data-parallel step on the rank's
    block of x's rows.  Rank 0 saves, a case each, the first step's loss
    and summed gradients, ms a step and ms of the gradient all-reduce
    alone (host clock around ``reps`` calls ended by a synchronize, both
    ranks released by a barrier), its align-reduce launches, and the
    seconds from entry to the group, the model and the first step."""
    t_in = time.perf_counter()
    # TF32 off as in the parent (a spawned process starts from the defaults)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(dev_name)
    init_data_parallel(rank, world, port, device=dev, backend="gloo")
    results = []
    try:
        reset_launch_counts()
        for cfg, dtype, x, draws in cases:
            tm = {"group_s": time.perf_counter() - t_in}
            tr = Trainer(cfg, compute_dtype=getattr(torch, dtype), device=dev,
                         group=dist.group.WORLD)
            tr.init_state(seed=5)
            r0, r1 = row_block(len(x), rank, world)
            xl = torch.from_numpy(x[r0:r1]).to(dev)
            tm["model_s"] = time.perf_counter() - t_in
            loss = float(tr.train_step(xl, draws, len(x)))
            grads = [p.grad.detach().cpu() for p in tr.model.parameters()]
            tm["first_step_s"] = time.perf_counter() - t_in

            def wall_ms(fn):
                sync(dev)
                dist.barrier()
                t0 = time.perf_counter()
                for _ in range(reps):
                    fn()
                sync(dev)
                return (time.perf_counter() - t0) / reps * 1e3

            step_ms = wall_ms(lambda: tr.train_step(xl, draws, len(x)))
            ar_ms = wall_ms(tr.all_reduce_grads)
            results.append(dict(loss=loss, grads=grads, step_ms=step_ms, ar_ms=ar_ms,
                                rows=r1 - r0, times=tm))
            del tr, xl
            torch.cuda.empty_cache()
        if rank == 0:
            torch.save(dict(cases=results, launches=align_reduce.launches), out)
    finally:
        dist.destroy_process_group()


def l2_rel(got, want):
    """||got - want|| / ||want|| over lists of tensors, in f64."""
    return float(torch.sqrt(sum(((a.double() - b.double()) ** 2).sum()
                                for a, b in zip(got, want)))
                 / torch.sqrt(sum((b.double() ** 2).sum() for b in want)))


def dp_cases(dev, card, tmp, cases, reps):
    """Phase 10 (c): each case (cfg, dtype, rows, gates) as 2 gloo ranks
    against the one-process step on the same batch, draws and weights
    (seed 5); ``gates`` = (loss rel, gradient L2 rel, elements outside
    rtol 3e-3 / atol 1e-4 allowed).  A gradient gate given as a string
    "<x> bf16" is x times the L2 distance between the one-process step's
    gradient and the f32 step's (TF32 off) on the same inputs: each rank's
    bf16 partial sums round apart, and this net's bf16 gradients sit far
    from f32 (the CPU bf16 step test's calibration); the element count is
    then not gated.  Returns the ranks' launches."""
    runs = []
    for cfg, dtype, rows, gates in cases:
        F, T = cfg["n_mels"], 32
        x = (np.random.default_rng(rows).standard_normal((rows, F, T)) * 2 - 4).astype(
            np.float32)
        runs.append((cfg, dtype, x, SpecAugment(cfg).draw(seeded_generator(123, 10, rows), F, T)))
    out = os.path.join(tmp, "dp_ranks.pt")
    torch.cuda.empty_cache()
    tm = time.perf_counter()
    spawn_ranks(dp_step_rank, 2, args=(runs, str(dev), out, reps), timeout=900)
    spawn_s = time.perf_counter() - tm
    got = torch.load(out)
    for (cfg, dtype, x, draws), (_, _, rows, gates), r in zip(runs, cases, got["cases"]):
        one = Trainer(cfg, compute_dtype=getattr(torch, dtype), device=dev)
        one.init_state(seed=5)
        xd = torch.from_numpy(x).to(dev)
        loss1 = float(one.train_step(xd, draws))
        g1 = [p.grad.detach().cpu() for p in one.model.parameters()]
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            one.train_step(xd, draws)
        sync(dev)
        one_ms = (time.perf_counter() - t0) / reps * 1e3
        del one, xd
        loss_rel = abs(r["loss"] / loss1 - 1)
        grad_rel = l2_rel(r["grads"], g1)
        outside = sum(int(((a - b).abs() > 1e-4 + 3e-3 * b.abs()).sum())
                      for a, b in zip(r["grads"], g1))
        n_par = sum(b.numel() for b in g1)
        grad_gate, calib = gates[1], ""
        if isinstance(grad_gate, str):
            f32 = Trainer(cfg, compute_dtype=torch.float32, device=dev)
            f32.init_state(seed=5)
            f32.train_step(torch.from_numpy(x).to(dev), draws)
            d_f32 = l2_rel(g1, [p.grad.detach().cpu() for p in f32.model.parameters()])
            del f32
            torch.cuda.empty_cache()
            grad_gate = float(grad_gate.split()[0]) * d_f32
            calib = " = %s x the one-process bf16 vs f32 distance %.2e" % (
                gates[1].split()[0], d_f32)
        print("  10c %s data-parallel step, %d global rows as 2 gloo ranks of %d rows on %s: "
              "loss %.7f vs one process %.7f (rel %.2e, gate %.0e); summed grads vs one "
              "process: L2 rel %.2e (gate %.2e%s), %d of %d entries outside rtol 3e-3 / atol "
              "1e-4 (gate %s); %.3f ms a step (one process %.3f ms), gradient all-reduce "
              "alone %.3f ms (%.1f MB of f32, gloo through the host)  %s" % (
                  dtype, rows, r["rows"], dev, r["loss"], loss1, loss_rel, gates[0],
                  grad_rel, grad_gate, calib, outside, n_par, gates[2], r["step_ms"],
                  one_ms, r["ar_ms"], 4 * n_par / 1e6, card), flush=True)
        if loss_rel > gates[0] or grad_rel > grad_gate or (gates[2] is not None
                                                            and outside > gates[2]):
            raise AssertionError("10c: the %s data-parallel step differs from the "
                                 "one-process step" % dtype)
    print("  10c the ranks: %.1f s from spawn to exit; rank 0's seconds from entry to the "
          "group, the model and the first step, a case each: %s  %s" % (
              spawn_s, ["%.1f/%.1f/%.1f" % (c["times"]["group_s"], c["times"]["model_s"],
                                            c["times"]["first_step_s"]) for c in got["cases"]],
              card), flush=True)
    return got["launches"]


def multi_gpu_paths(dev, card, tmp, big, p4, p6, synth, dp_rows=(32, 640), dp_reps=4):
    """Phase 10: the multi-GPU paths on one card.  (a) the screened engine
    sharded over [dev, dev] at phase 6's scale, held to phase 6's answers;
    (b) phase 4's corpus through Database with sharded: true over
    [dev, dev], held to phase 4's answers; (c) the data-parallel train step
    as 2 gloo ranks on the one card, held to the one-process step (f32 on
    dp_rows[0] rows with ELU, tightly; the flagship bf16 at dp_rows[1]);
    (d) python -m pfann_tpu_torch.train --dp for 1 epoch on phase 9's
    synthetic corpus (one NCCL rank per visible card).  ``big`` is phase
    6's corpus (emb, counts); p4, p6 their batches and answers; synth
    phase 9 (b)'s config.  Returns the largest kernel-vs-plain errors."""
    phase(10, "multi-GPU paths on one card: sharded serving over 2 shards, the "
              "data-parallel step as 2 gloo ranks, train --dp")
    devices = [dev, dev]
    d, S, k = 128, 19, 4

    # (a) ------------------------------------------------------------
    emb, counts = big
    f, src, off = p6["f"], p6["src"], p6["off"]
    B = len(f)
    torch.cuda.empty_cache()
    tm = time.perf_counter()
    sdb = ShardedDatabase(emb, counts, devices, engine="screen", db_dtype=torch.bfloat16,
                          align_pad=32, screen_k=k, screen_top_m=32,
                          screen_coarse_dtype="int8", screen_rescue=0.4)
    sync(dev)
    print("  10a %d songs over %d shards: build %.1f s, R=%d Rc=%d, %d slots a shard, "
          "resident MB per shard %s  %s" % (
              len(counts), sdb.n_shards, time.perf_counter() - tm, sdb.R, sdb.Rc,
              sdb.songs_max, ["%.1f" % (b / 1e6) for b in sdb.resident_bytes()], card),
          flush=True)
    sdb.search_top1_rescued(f[:64])
    reset_launch_counts()
    _, idx, t = sdb.search_top1_rescued(f)
    sync(dev)
    n = record("10a: sharded screened engine, clean batch")
    song = sdb.flat_to_song(idx)
    hits, right = int((song == src).sum()), int((t == off).sum())
    same = int(((song == p6["song"]) & (t == p6["t"])).sum())
    if hits != B or right != B or same != B or n["int8"] != sdb.n_shards:
        raise AssertionError("10a clean: recall %d/%d, offsets %d, == phase 6 %d, int8 "
                             "launches %d" % (hits, B, right, same, n["int8"]))
    batch_ms = time_ms(lambda: sdb.search_top1_rescued(f), 3)
    with profiling.device_trace(os.path.join(tmp, "trace10a")) as prof:
        sdb.search_top1_rescued(f)
        sync(dev)
    ops = sorted(((e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA), key=lambda kv: -kv[1])
    print("  10a clean batch (%d queries): recall %d/%d, offsets right %d/%d, answers == phase "
          "6's unsharded engine %d/%d; launches int8 %d bf16 %d (phase 6 escalated %d); "
          "search_top1_rescued %.3f ms a batch = %.1f queries/s (phase 6 unsharded %.3f ms = "
          "%.1f queries/s)  %s" % (
              B, hits, B, right, B, same, B, n["int8"], n["bf16"], p6["esc"], batch_ms,
              B / batch_ms * 1e3, p6["batch_ms"], B / p6["batch_ms"] * 1e3, card), flush=True)
    print("  10a profile of one clean batch (torch.profiler), five longest device ops (ms): "
          "%s  %s" % ("; ".join("%s %.3f" % (k_[:60], v) for k_, v in ops[:5]), card),
          flush=True)
    # one shard's int8 stage-1 launch against its plain version, bitwise
    sh = sdb.shards[0]
    qc8 = quantize_queries_int8(collapse_queries(torch.from_numpy(f).to(dev), k))
    err8 = compare_exact(sh.coarse, qc8, sdb.Rc, qc8.shape[1], sdb.songs_max)
    s1_ms = time_ms(lambda: align_reduce(sh.coarse, qc8, sdb.Rc, qc8.shape[1], sdb.songs_max), 5)
    print("  10a one shard's int8 stage-1 launch (%d slots, Sc=%d, B=%d): %.3f ms, == its plain "
          "version bitwise  %s" % (sdb.songs_max, qc8.shape[1], B, s1_ms, card), flush=True)
    del qc8
    fn = p6["fn"]
    reset_launch_counts()
    _, idx, tn = sdb.search_top1_rescued(fn)
    sync(dev)
    n = record("10a: sharded screened engine, noisy batch")
    song_n = sdb.flat_to_song(idx)
    same = (song_n == p6["fsong"]) & (tn == p6["ft"])
    clear = p6["clear"]
    chunks = -(-len(fn) // sdb._chunk(S))
    if not same[clear].all() or n["bf16"] != sdb.n_shards * chunks:
        raise AssertionError("10a noisy: %d answers differ from the exhaustive engine's where "
                             "its margin is clear; bf16 launches %d" % (
                                 int((~same[clear]).sum()), n["bf16"]))
    noisy_ms = time_ms(lambda: sdb.search_top1_rescued(fn), 1)
    print("  10a noisy batch (%d queries): answers == the exhaustive engine's on %d/%d with a "
          "clear margin (%d/%d in all); launches int8 %d bf16 %d (one per shard per escalating "
          "chunk); %.3f ms a batch (phase 6 unsharded %.3f ms)  %s" % (
              len(fn), int(same[clear].sum()), int(clear.sum()), int(same.sum()), len(fn),
              n["int8"], n["bf16"], noisy_ms, p6["noisy_ms"], card), flush=True)
    del sdb, sh
    torch.cuda.empty_cache()

    # (b) ------------------------------------------------------------
    emb4, f4 = p4["emb"], p4["f"]
    per = 120
    n4 = emb4.shape[0] // per
    db_dir = os.path.join(tmp, "db10b")
    os.makedirs(db_dir)
    emb4.tofile(os.path.join(db_dir, "embeddings"))
    np.full(n4, per, np.int32).tofile(os.path.join(db_dir, "landmarkKey"))
    with open(os.path.join(db_dir, "songList.txt"), "w") as fh:
        fh.writelines("song%05d.wav\n" % i for i in range(n4))
    write_index_meta(db_dir, d=d, meta={"ntotal": int(emb4.shape[0])})
    tm = time.perf_counter()
    db = Database(db_dir, {"top_k": 100, "engine": "align", "sharded": True}, 0.5, dev,
                  devices=devices)
    sync(dev)
    sdb = db._sharded
    queries = list(f4)
    print("  10b phase 4's corpus as a DB, sharded: true over %d shards: build %.1f s, R=%d, "
          "resident MB per shard %s  %s" % (
              sdb.n_shards, time.perf_counter() - tm, sdb.R,
              ["%.1f" % (b / 1e6) for b in sdb.resident_bytes()], card), flush=True)
    db.query_top1_batch(queries[:32])
    reset_launch_counts()
    ans = db.query_top1_batch(queries)
    sync(dev)
    n = record("10b: Database sharded: true, align engine")
    song = np.array([a[1][0] for a in ans])
    t = np.array([a[1][1] for a in ans]) / 0.5
    hits = int((song == p4["src"]).sum())
    same = (song == p4["song"]) & (t == p4["t"])
    clear = p4["clear"]
    if hits != len(f4) or not same[clear].all() or n["bf16"] != sdb.n_shards:
        raise AssertionError("10b: recall %d/%d, %d answers differ from phase 4's where the "
                             "margin is clear, bf16 launches %d" % (
                                 hits, len(f4), int((~same[clear]).sum()), n["bf16"]))
    db_ms = time_ms(lambda: db.query_top1_batch(queries), 3)
    raw_ms = time_ms(lambda: sdb.search_top1_device(f4), 5)
    q = torch.from_numpy(f4).to(dev, torch.bfloat16)
    err, nbad, _, _ = compare(sdb.shards[0].db, q, sdb.R, S, sdb.songs_max)
    print("  10b %d queries: recall %d/%d, answers == phase 4's on %d/%d with a clear margin "
          "(%d/%d in all), bf16 launches %d; Database.query_top1_batch %.3f ms a batch (its "
          "filters padded to S=%d), search_top1_device at S=%d %.3f ms (phase 4's one launch "
          "%.3f ms); one shard's launch vs plain max|dbest| %.2e, argoff ties %d  %s" % (
              len(f4), hits, len(f4), int(same[clear].sum()), int(clear.sum()),
              int(same.sum()), len(f4), n["bf16"], db_ms, db._filters(queries[:1])[0].shape[1],
              S, raw_ms, p4["ms"], err, nbad, card), flush=True)
    del db, sdb, q
    torch.cuda.empty_cache()

    # (c) ------------------------------------------------------------
    # f32 tightly (ELU: a ReLU input at the kink may flip between batch
    # splits, phase 9); bf16 within the bf16 step test's loss tolerance and
    # a gradient gate calibrated on bf16's own distance from f32
    elu = dict(synth, model=dict(synth["model"], conv_activation="ELU"))
    launches = dp_cases(dev, card, tmp, [(elu, "float32", dp_rows[0], (1e-5, 1e-4, 0)),
                                         (synth, "bfloat16", dp_rows[1], (1e-2, "2 bf16", None))],
                        dp_reps)
    PATHS["10c: data-parallel steps, 2 gloo ranks (rank 0's count)"] = {
        "bf16": launches, "f32": 0, "int8": 0}
    if launches:
        raise AssertionError("10c: the data-parallel step launched the align-reduce kernel")

    # (d) ------------------------------------------------------------
    cfg = dict(synth, epoch=1, model_dir=os.path.join(tmp, "dp_model"))
    path = os.path.join(tmp, "dp.json")
    with open(path, "w") as fh:
        json.dump(cfg, fh, indent=2)
    tm = time.perf_counter()
    out = train_cli(["-p", path, "-w", "4", "--dp", "--device", dev.type], tmp, 900)
    dp_s = time.perf_counter() - tm
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    if "data-parallel over %d devices" % n_dev not in out:
        raise AssertionError("10d: the CLI did not print data-parallel over %d devices" % n_dev)
    for name in ("checkpoint0.ckpt", "epochs.txt", "date.txt", "configs.json",
                 "metrics.jsonl", "model.msgpack"):
        if not os.path.exists(os.path.join(cfg["model_dir"], name)):
            raise AssertionError("10d: model dir lacks " + name)
    m = epoch_metrics(cfg["model_dir"])
    print("  10d python -m pfann_tpu_torch.train --dp, 1 epoch of phase 9's corpus: %.1f s of "
          "wall, data-parallel over %d devices (%s), loss %.4f, epoch %.3f s for %d steps, "
          "validation top-1 %.3f; the checkpoint contract's files written (the rank is a "
          "child process, whose launch counts this process cannot read)  %s" % (
              dp_s, n_dev, "NCCL" if dev.type == "cuda" else "gloo",
              m[("train/loss", 0)], m[("train/epoch_s", 0)], int(m[("train/steps", 0)]),
              m[("validation/accuracy", 0)], card), flush=True)
    return {"bf16": err, "int8": err8}


# bench.py's JSON keys by mode (bench.py:186-290, 378-392, 451-520,
# 599-613, 750-791, 853-861); the port's lines add "device"
_HEAD = {"metric", "value", "unit", "vs_baseline"}
_SCREENED = _HEAD | {"mode", "n_songs", "recall_sanity", "rescue_path"}
_DB = {"metric", "unit", "n_songs", "db", "engine", "value", "vs_baseline", "recall_sanity"}
BENCH_KEYS = {
    "default --batch-sweep": _HEAD | {"batch_curve", "train_step_ms"},
    "--sharded": _HEAD | {"mode", "train_step_ms"},
    "--scale": _SCREENED | {"bare_top1_qps", "recall_noisy", "rescued_top1_qps_noisy"},
    "--scale --int8-exact": _SCREENED | {"hbm_bytes_in_use"},
    "--long": {"metric", "unit", "S", "n_songs", "screen_pad128_qps", "value",
               "vs_baseline", "topk_qps"},
    "--db": _DB,
    "--db screen": _DB | {
        "align_control_qps", "align_control_recall", "bare_top1_qps",
        "rescued_top1_qps_clean", "rescued_top1_parity_clean", "rescued_top1_qps_noisy",
        "rescued_top1_parity_noisy", "rescued_search_qps_clean",
        "rescued_search_qps_noisy"},
    "--lm": {"metric", "value", "unit", "host_audio_s_per_sec", "speedup",
             "hash_agreement", "n_songs"},
    "--build": {"metric", "value", "unit", "vs_baseline", "embeddings_per_sec", "n_songs",
                "pipeline_depth", "phase_split_s"},
    "--train-epoch": {"metric", "value", "unit", "epoch_s", "n_segments", "loss", "host_s",
                      "dispatch_s", "device_corpus"},
}


@contextlib.contextmanager
def launch_shapes(keep=None):
    """Inside the block, note (dtype, R, S, B, n_songs) of every align-reduce
    launch the engines make (``alignment_core`` calls it through
    pfann_tpu_torch.index.align) and keep the inputs (db, queries) of the
    first launch of each shape that ``keep`` selects.  Yields (shapes,
    kept); the launch counts are the wrapper's own, untouched."""
    shapes, kept = [], {}
    real = align_mod.align_reduce

    def noting(db, q, R, S, n_songs):
        shape = (db.dtype, R, S, q.shape[0], n_songs)
        shapes.append(shape)
        if keep is not None and keep(shape) and shape not in kept:
            kept[shape] = (db, q)
        return real(db, q, R, S, n_songs)

    align_mod.align_reduce = noting
    try:
        yield shapes, kept
    finally:
        align_mod.align_reduce = real


def ported_bench(dev, card, db10k, train_cfg, n_songs=10_000, scale=30_000,
                 audio_songs=256, train_rows=1280):
    """Phase 11: python -m pfann_tpu_torch.bench, every mode of bench.py,
    in process with stdout captured: default with --batch-sweep,
    --sharded, --scale 30000 (bf16 stage 1; phase 6 serves 100k songs),
    --scale 30000 --int8-exact,
    --long 10000, --db on phase 7's 10k-song DB (``db10k``) as written (bf16
    align), with db_dtype float32 and with screen: true (int8 stage 1),
    --lm 256, --build 256 and --train-epoch on phase 9's synthetic config
    (``train_cfg``).  Each mode's JSON line is printed and must carry
    bench.py's keys and this card; each mode's launches are recorded and
    must be of the forms its path runs.  The bf16 launches no earlier phase
    makes at their scale are held to the plain version: stage 1 at 30k
    songs (Rc=40, Sc=5, B=1024), the long-query coarse stage (Sc=30 over
    10k songs) and the sweep's B = 128, 256 and 512.  The keywords cut the
    run for a rehearsal on the CPU (``n_songs`` for default, --sharded and
    --long; ``scale``; ``audio_songs`` for --lm and --build; the train
    step's rows).  Returns the largest bf16 |dbest| of those holds."""
    phase(11, "the ported bench: python -m pfann_tpu_torch.bench, every mode of bench.py")
    smi = card[1:-1]
    tm0 = time.perf_counter()
    bf16 = torch.bfloat16
    errs = []  # the holds' largest |dbest|

    def drive(label, keys, fn, *args, keep=None, **kw):
        """One mode: its lines (``BENCH_KEYS[keys]`` and the card checked,
        printed), the launches by form, and the shapes (and kept inputs) it
        launched."""
        torch.cuda.empty_cache()
        buf = io.StringIO()
        reset_launch_counts()
        tm = time.perf_counter()
        with launch_shapes(keep) as (shapes, kept), contextlib.redirect_stdout(buf):
            fn(*args, device=dev, **kw)
        torch.cuda.synchronize()
        n = record("11: bench " + label)
        lines = [json.loads(ln) for ln in buf.getvalue().splitlines() if ln.startswith("{")]
        want = BENCH_KEYS[keys] | {"device"}
        if not lines or any(set(ln) != want or ln["device"] != smi for ln in lines):
            raise AssertionError("11 %s: lines %s, want keys %s on %s"
                                 % (label, lines, sorted(want), smi))
        for ln in lines:
            print("  11 %s (%.1f s): %s  %s" % (label, time.perf_counter() - tm,
                                                json.dumps(ln), card), flush=True)
        print("  11 %s launches: %s" % (label, n), flush=True)
        return lines, n, shapes, kept

    def forms(label, n, *on):
        """The kernel forms ``on`` launched, and no other."""
        if any((n[f] > 0) != (f in on) for f in n):
            raise AssertionError("11 %s launched %s, want %s only" % (label, n, on or "none"))

    def hold(name, kept, shape):
        db, q = kept.pop(shape)
        _, R, S, _, n_songs = shape
        errs.append(held_launch(name, db, q, R, S, n_songs, card)["err"])

    # the exhaustive engine: headline and sweep, then one shard
    sweep = {128, 256, 512}
    _, n, shapes, kept = drive(
        "default --batch-sweep", "default --batch-sweep", port_bench.main, batch_sweep=True,
        n_songs=n_songs, train_rows=train_rows, keep=lambda s: s[0] == bf16 and s[3] in sweep)
    forms("default --batch-sweep", n, "bf16")
    if not sweep <= {s[3] for s in shapes if s[0] == bf16}:
        raise AssertionError("11 sweep launched B %s" % sorted({s[3] for s in shapes}))
    for shape in sorted(kept, key=lambda s: s[3]):
        hold("sweep B=%d" % shape[3], kept, shape)
    _, n, _, _ = drive("--sharded", "--sharded", port_bench.main, sharded=True,
                       n_songs=n_songs, train_rows=train_rows)
    forms("--sharded", n, "bf16")

    # the screened engine at 30k songs: bf16 stage 1 (Rc=40, Sc=5), the
    # rescue at R=160, S=19
    tag = "--scale %d" % scale
    _, n, shapes, kept = drive(tag, "--scale", port_bench.main, scale=scale,
                               keep=lambda s: s[:3] == (bf16, 40, 5) and s[4] == scale)
    forms(tag, n, "bf16")
    if len(kept) != 1 or not any(s[:3] == (bf16, 160, 19) for s in shapes):
        raise AssertionError("11 %s: bf16 stage-1 launches %s, a rescue launch: %s"
                             % (tag, list(kept), any(s[1] == 160 for s in shapes)))
    hold(tag + " stage 1", kept, next(iter(kept)))
    _, n, _, _ = drive(tag + " --int8-exact", "--scale --int8-exact", port_bench.main,
                       scale=scale, int8_exact=True)
    forms(tag + " --int8-exact", n, "int8")

    # 60 s queries: the screen's bf16 coarse stage at Sc=30 over 10k songs
    _, n, _, kept = drive("--long %d" % n_songs, "--long", port_bench.long_query_bench,
                          n_songs, keep=lambda s: s[0] == bf16 and s[2] == 30)
    forms("--long", n, "bf16")
    if len(kept) != 1:
        raise AssertionError("11 --long: bf16 launches at Sc=30: %s" % list(kept))
    hold("--long coarse Sc=30", kept, next(iter(kept)))

    # phase 7's DB directory, three ways
    cfg_path = os.path.join(db10k, "configs.json")
    for label, extra, on in (("--db", {}, ("bf16",)),
                             ("--db db_dtype float32", {"db_dtype": "float32"}, ("f32",)),
                             ("--db screen: true", {"screen": True,
                                                     "screen_coarse_dtype": "int8"},
                              ("bf16", "int8"))):
        with open(cfg_path, "w") as fh:
            json.dump({"hop_size": 0.5, "indexer": dict(top_k=100, **extra)}, fh)
        lines, n, _, _ = drive(label + " on db10k", "--db screen" if "screen" in extra
                               else "--db", port_bench.db_bench, db10k)
        forms(label, n, *on)
        if lines[0]["engine"] != ("screen" if "screen" in extra else "align"):
            raise AssertionError("11 %s served by %s" % (label, lines[0]["engine"]))

    # the rest: no align-reduce launch on their paths
    _, n, _, _ = drive("--lm %d" % audio_songs, "--lm", port_bench.landmark_bench,
                       audio_songs)
    forms("--lm", n)
    _, n, _, _ = drive("--build %d" % audio_songs, "--build", port_bench.build_bench,
                       audio_songs)
    forms("--build", n)
    _, n, _, _ = drive("--train-epoch", "--train-epoch", port_bench.sustained_train,
                       train_cfg)
    forms("--train-epoch", n)
    print("  11 wall %.1f s  %s" % (time.perf_counter() - tm0, card), flush=True)
    return max(errs)


# ------------------------------------------------------------ 12-13
SNRS = (-6, -4, -2, 0, 2, 4, 6, 8)
# the accuracy bands of phase 12, song top-1 % (fsm: exact-match %)
NN10_MIN, LM10_MIN = 95.0, 90.0
NN3_MIN = {-6: 60.0, 8: 90.0}
# two bf16 embedders (card cuDNN, CPU f32 on bf16-rounded operands) give
# mean scores within this (the port tests' bf16 tolerance); a card-vs-CPU
# top-1 may differ only where the card's margin is under twice it
CPU_SCORE_ATOL = 2e-2
_ACC_LINE = re.compile(r"^(exact match|near match|song) correct \d+ acc ([0-9.]+)$")
_FORM = {"bfloat16": "bf16", "int8": "int8", "float32": "f32"}
# each harness step is a process that takes seconds to reach the card for
# little work at these sizes: the drivers run their per-SNR steps 8 at once
HARNESS_JOBS = 8


def harness_child(label, module, argv, cwd, launch_log, timeout, env=None):
    """python -m pfann_tpu_torch.<module> in ``cwd`` (``env`` added to its
    environment), each port process under it appending its align-reduce
    launches to ``launch_log`` as it exits.  Its stdout and stderr go whole
    to <cwd>/chip_smoke_<label>.log; returns (stdout, wall s).  A nonzero
    exit fails with the output's tail."""
    log = os.path.join(cwd, "chip_smoke_%s.log" % label)
    env = child_env(cwd, PFANN_LAUNCH_LOG=launch_log, **(env or {}))
    tm = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "pfann_tpu_torch." + module, *argv], cwd=cwd,
                       env=env, capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - tm
    with open(log, "w") as fh:
        fh.write(r.stdout + "\n---- stderr ----\n" + r.stderr)
    if r.returncode:
        raise AssertionError("%s exited %d after %.1f s; stdout tail:\n%s\nstderr tail:\n%s"
                             % (module, r.returncode, wall, r.stdout[-3000:],
                                r.stderr[-3000:]))
    return r.stdout, wall


def child_launches(launch_log):
    """The align-reduce launches by form that the child processes logged."""
    out = {"bf16": 0, "int8": 0, "f32": 0}
    if os.path.exists(launch_log):
        with open(launch_log) as fh:
            for line in fh:
                for k, v in json.loads(line)["launches"].items():
                    out[_FORM[k]] += v
    return out


def pipeline_accuracy(stdout):
    """{arm: {snr: {"exact"|"near"|"song": %}}} and {step: wall s} from
    run_synth_pipeline's stdout: testall's blocks ("snr=S" and three lines
    of tools/accuracy.py) belong to the step whose "step <name> <s> s" line
    follows them; the fsm sweep's blocks carry "fsm=F snr=S" (arm fsmF)."""
    acc, walls, pending, label = {}, {}, {}, None
    for line in stdout.splitlines():
        m = re.match(r"^step (.+) ([0-9.]+) s$", line)
        if m:
            walls[m.group(1)] = float(m.group(2))
            if pending:
                acc[m.group(1)], pending = pending, {}
            continue
        m = re.match(r"^(?:fsm=(\d+) )?snr=(-?\d+)$", line)
        if m:
            label = ("fsm" + m.group(1) if m.group(1) else None, int(m.group(2)))
            continue
        m = _ACC_LINE.match(line)
        if m and label:
            into = acc.setdefault(label[0], {}) if label[0] else pending
            into.setdefault(label[1], {})[m.group(1).split()[0]] = float(m.group(2))
    return acc, walls


def accuracy_bands(acc):
    """Phase 12's bands; the misses, as strings."""
    nn10, nn3, lm10 = (acc["testall %s" % a] for a in
                       ("synth synth", "synth synth3s", "lm synth"))
    miss = []
    for snr in SNRS:
        if nn10[snr]["song"] < NN10_MIN:
            miss.append("NN 10 s at %+d dB: %.2f < %.0f" % (snr, nn10[snr]["song"], NN10_MIN))
        if lm10[snr]["song"] < LM10_MIN:
            miss.append("landmark 10 s at %+d dB: %.2f < %.0f"
                        % (snr, lm10[snr]["song"], LM10_MIN))
        if acc["fsm2"][snr]["exact"] < nn10[snr]["exact"]:
            miss.append("fsm=2 exact at %+d dB: %.2f < fsm=1's %.2f"
                        % (snr, acc["fsm2"][snr]["exact"], nn10[snr]["exact"]))
    for snr, low in NN3_MIN.items():
        if nn3[snr]["song"] < low:
            miss.append("NN 3 s at %+d dB: %.2f < %.0f" % (snr, nn3[snr]["song"], low))
    return miss


def held_int8(name, db, q, R, S, n_songs, card):
    """The int8 kernel at one main-path shape: bitwise against the plain
    version, timed (3 calls) beside the plain version, torch._int_mm's
    products and the bound.  Returns the numbers."""
    err = compare_exact(db, q, R, S, n_songs)
    ms = time_ms(lambda: align_reduce(db, q, R, S, n_songs), 3)
    plain_ms = time_ms(lambda: align_reduce_reference(db, q, R, S, n_songs), 1)
    lib_ms = int_mm_library_ms(db, q, 3)
    bnd = bound(torch.int8, db.shape[0], db.shape[1], S, q.shape[0], n_songs, R)
    print("  int8 kernel, %s (R=%d, S=%d, B=%d, %d songs): %.3f ms, plain %.3f ms, _int_mm "
          "%.3f ms, %s; == plain bitwise  %s" % (name, R, S, q.shape[0], n_songs, ms, plain_ms,
                                                 lib_ms, fmt_bound(bnd), card), flush=True)
    print("  int8 max|dbest| %s: %.3e" % (name, err), flush=True)
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound": bnd}


def query_embeddings_of(qemb_dir, d):
    """[S, d] float32 arrays of an extractemb directory, in list order."""
    emb = np.fromfile(os.path.join(qemb_dir, "query_embeddings"), np.float32).reshape(-1, d)
    idx = np.fromfile(os.path.join(qemb_dir, "query_index"), np.int64).reshape(-1, 2)
    return [emb[a : a + n] for a, n in idx]


def open_db(root, tag, dev):
    path = os.path.join(root, "out", "dbs", "%s_synth" % tag)
    with open(os.path.join(path, "configs.json")) as fh:
        params = json.load(fh)
    return Database(path, params["indexer"], params["hop_size"], dev), params


def harness_on_card(dev, card, root, db_songs=100, num_queries=100, extra=(), bands=True,
                    timeout=1500):
    """Phases 12-13: the evaluation harness through its drivers, each a child
    process tree under ``root``; then the kernel shapes the harness
    launched, held to the plain version in this process.  ``extra`` (corpus
    and epoch flags) and ``bands=False`` cut the run for a rehearsal on the
    CPU.  Returns the holds' largest |dbest| by form."""
    phase(12, "the synthetic pipeline: python -m pfann_tpu_torch.tools.run_synth_pipeline")
    log12 = os.path.join(root, "launches12.jsonl")
    out, wall = harness_child(
        "run_synth_pipeline", "tools.run_synth_pipeline",
        ["--root", root, "--db-songs", str(db_songs), "--num-queries", str(num_queries),
         "--fsm", "2", "--device", dev.type, "--jobs", str(HARNESS_JOBS), *extra], root, log12,
        timeout)
    if out.splitlines()[-1:] != ["PIPELINE_DONE"]:
        raise AssertionError("run_synth_pipeline did not print PIPELINE_DONE")
    n12 = PATHS["12: run_synth_pipeline (child processes)"] = child_launches(log12)
    acc, walls = pipeline_accuracy(out)
    print("  12 run_synth_pipeline --db-songs %d --num-queries %d: %.1f s; per step: %s  %s"
          % (db_songs, num_queries, wall, ", ".join("%s %.1f" % kv for kv in walls.items()),
             card), flush=True)
    print("  12 %s" % next(ln for ln in out.splitlines() if ln.startswith("fuse")
                           or ln.startswith("step fuse")), flush=True)
    for arm in ("testall synth synth", "testall synth synth3s", "testall lm synth",
                "testall lm synth3s", "fsm2"):
        for metric in ("song", "exact"):
            print("  12 %-22s %-5s top-1 %% at %s dB: %s" % (
                arm, metric, "/".join("%+d" % s for s in SNRS),
                " ".join("%.2f" % acc[arm][s][metric] for s in SNRS)), flush=True)
    print("  12 launches (child processes): %s" % n12, flush=True)
    if n12["bf16"] < 1:
        raise AssertionError("the pipeline's matchers launched no bf16 kernel")
    if bands:
        miss = accuracy_bands(acc)
        if miss:
            raise AssertionError("phase 12 bands missed: %s" % "; ".join(miss))
        print("  12 bands met: NN 10 s >= %.0f%%, NN 3 s >= %.0f%% at -6 and >= %.0f%% at +8 "
              "dB, landmark 10 s >= %.0f%%, fsm=2 exact >= fsm=1" % (
                  NN10_MIN, NN3_MIN[-6], NN3_MIN[8], LM10_MIN), flush=True)

    # the card against the CPU: the 10 s set at -6 dB through the port's
    # matcher on the CPU, in this process
    rel = os.path.join("out", "results", "synth_synth_snr-6.txt")
    cpu_res = os.path.join("out", "results", "cpu_synth_synth_snr-6.txt")
    tm = time.perf_counter()
    with contextlib.chdir(root):
        matcher.main(["matcher", "--pairs", "--batch", "128", "out/dbs/synth_synth",
                      "out/queries/synth_snr-6/list.txt", cpu_res, "--device", "cpu"])
    cpu_s = time.perf_counter() - tm
    lines = [open(os.path.join(root, p), "rb").read().splitlines() for p in (rel, cpu_res)]
    scores = [np.fromfile(os.path.join(root, p + ".bin"), np.float32)
              .reshape(len(lines[0]), -1, 2)[:, :, 0] for p in (rel, cpu_res)]
    top = np.sort(scores[0], axis=1)
    clear = top[:, -1] - top[:, -2] >= 2 * CPU_SCORE_ATOL
    differ = [i for i, (a, b) in enumerate(zip(*lines)) if a != b]
    dmax = float(np.abs(scores[0] - scores[1]).max())
    print("  12 card vs CPU matcher (-6 dB, %d queries, CPU %.1f s): %d TSV lines differ, "
          "%d of them with a clear card margin; max |dscore| %.2e  %s" % (
              len(lines[0]), cpu_s, len(differ), sum(clear[i] for i in differ), dmax, card),
          flush=True)
    if len(lines[0]) != len(lines[1]) or dmax > CPU_SCORE_ATOL or any(clear[i] for i in differ):
        raise AssertionError("the card's matcher TSV differs from the CPU's where the "
                             "margin is clear (or a score by more than %g)" % CPU_SCORE_ATOL)

    phase(13, "round-4 screen validation: tools.r04_pipeline, tools.r04_rescue")
    log13 = os.path.join(root, "launches13.jsonl")
    walls13 = {}
    for name in ("r04_pipeline", "r04_rescue"):
        _, walls13[name] = harness_child(name, "tools." + name, ["--device", dev.type, "--jobs",
                                                                 str(HARNESS_JOBS)], root,
                                         log13, timeout)
    n13 = PATHS["13: r04_pipeline + r04_rescue (child processes)"] = child_launches(log13)
    print("  13 r04_pipeline %.1f s, r04_rescue %.1f s; launches (child processes): %s  %s"
          % (walls13["r04_pipeline"], walls13["r04_rescue"], n13, card), flush=True)
    if n13["bf16"] < 1 or n13["int8"] < 1:
        raise AssertionError("phase 13 launched %s: want bf16 and int8 (screeni8)" % n13)
    for snr in SNRS:
        got = [csv_rows(os.path.join(root, "out", "results", "%s_synth_snr%d_detail.csv"
                                     % (tag, snr))) for tag in ("rescued", "alignctl")]
        if [r[:2] + r[3:4] for r in got[0]] != [r[:2] + r[3:4] for r in got[1]]:
            raise AssertionError("rescued answers differ from alignctl's at %+d dB" % snr)
    print("  13 rescued screen == alignctl on every query of every SNR (ids and times)",
          flush=True)
    with open(os.path.join(root, "ACCURACY_r04.md")) as fh:
        for line in fh:
            if line.startswith(("| screen", "| align", "Bare screen", "Screen+rescue")):
                print("  13 " + line.rstrip(), flush=True)

    # escalation per SNR and the kernel shapes, in this process: the rescued
    # screen over each SNR's query embeddings (128 a call, as matchemb)
    bf16, int8 = torch.bfloat16, torch.int8
    db, params = open_db(root, "rescued", dev)
    d = params["model"]["d"]
    sets = {snr: query_embeddings_of(os.path.join(root, "out", "qemb", "synth_snr%d" % snr), d)
            for snr in SNRS}
    shares = []
    with launch_shapes(lambda s: True) as (shapes, kept):
        for snr in SNRS:
            esc0 = db._align.escalated
            for at in range(0, len(sets[snr]), 128):
                db.query_embeddings_batch(sets[snr][at : at + 128])
            shares.append((db._align.escalated - esc0) / max(len(sets[snr]), 1))
    print("  13 rescued screen, share of queries escalated to stage 3 at %s dB: %s" % (
        "/".join("%+d" % s for s in SNRS), " ".join("%.4f" % x for x in shares)), flush=True)
    stage1 = next(s for s in kept if s[0] == bf16 and s[1] == db._align.Rc)
    stage3 = [s for s in kept if s[0] == bf16 and s[1] == db._align.R]
    holds = {"bf16": [], "int8": []}

    def hold(name, kept, shape):
        dbt, q = kept[shape]
        _, R, S, _, n_songs = shape
        if shape[0] == int8:
            holds["int8"].append(held_int8(name, dbt, q, R, S, n_songs, card)["err"])
        else:
            holds["bf16"].append(held_launch(name, dbt, q, R, S, n_songs, card)["err"])

    hold("13 bf16 stage 1 (rescued)", kept, stage1)
    if not stage3:
        # no query fell under the gate: stage 3's launch (the whole exact
        # layout) on -6 dB's first 128 queries, all escalated by a gate of 2
        print("  13 no query escalated; stage 3 held with every query escalated", flush=True)
        del db
        db, params = open_db(root, "rescued", dev)
        db = Database(os.path.join(root, "out", "dbs", "rescued_synth"),
                      dict(params["indexer"], screen_rescue=2.0), params["hop_size"], dev)
        with launch_shapes(lambda s: s[0] == bf16 and s[1] == db._align.R) as (_, kept):
            db.query_embeddings_batch(sets[-6][:128])
        stage3 = list(kept)
    hold("13 bf16 stage 3 (rescued)", kept, stage3[0])
    del db, kept
    db, _ = open_db(root, "screeni8", dev)
    with launch_shapes(lambda s: s[0] == int8) as (_, kept):
        db.query_embeddings_batch(sets[-6][:128])
    hold("13 int8 stage 1 (screeni8)", kept, next(iter(kept)))
    # the exhaustive engine at B=128: 10 s queries (19 rows) and their first
    # 5 rows (the 3 s sets' length), -6 dB then -4 dB filling the batch
    del db, kept
    db, _ = open_db(root, "synth", dev)
    batch = (sets[-6] + sets[-4])[:128]
    for rows in (19, 5):
        with launch_shapes(lambda s: s[0] == bf16) as (_, kept):
            db.query_embeddings_batch([q[:rows] for q in batch])
        shape = next(iter(kept))
        hold("12 bf16 exhaustive, %d-row queries" % rows, kept, shape)
    del db, kept
    torch.cuda.empty_cache()
    return {k: max(v) for k, v in holds.items()}


# ------------------------------------------------------------ 14-15
# phase 14: distractors that grow phase 12's 130-track DB to 30,000 songs,
# where Database picks the screen by the auto path; 2 s each (never queried)
SCALE_DISTRACT = (29_870, 2)
SCALE_SONGS = 30_000
# phase 15: small corpora through the r05 drivers' environment; the
# flagship-width model trains on configs/flagship.json with epoch 1
R05_ENV = {"NQ": "8", "NQ10": "8", "NQ60": "2", "COVER_SUB": "0.03", "COVER_JITTER": "0.02",
           "R5_ROOT": "out/r5_smoke", "R5M_ROOT": "out/r5m_smoke"}
R05_EPOCHS = 1
# (root, make_synth_corpus flags); cal_sub* and the r5 roots as the scripts
# make them (family size 4, every song a cover), cut to a few songs
R05_CORPORA = [("out/synth_big", ("--train-songs", 60, "--val-songs", 10, "--db-songs", 0,
                                  "--test-songs", 0, "--seconds", 30, "--seed", 5))] + [
    ("out/cal_sub%d" % sub, ("--train-songs", 0, "--val-songs", 0, "--db-songs", 6,
                             "--test-songs", 2, "--seconds", 12, "--family-size", 4,
                             "--cover-frac", "1.0", "--cover-sub", "0.%d" % sub,
                             "--cover-jitter", "0.06", "--seed", seed))
    for sub, seed in ((10, 61), (25, 62), (45, 63))] + [
    (R05_ENV[var], ("--train-songs", 0, "--val-songs", 0, "--db-songs", songs,
                    "--test-songs", test, "--seconds", seconds, "--family-size", 4,
                    "--cover-frac", "1.0", "--cover-sub", R05_ENV["COVER_SUB"],
                    "--cover-jitter", R05_ENV["COVER_JITTER"], "--seed", seed))
    for var, songs, test, seconds, seed in (("R5_ROOT", 12, 8, 12, 71),
                                            ("R5M_ROOT", 2, 2, 64, 72))]


def child_env(root, **extra):
    """The environment of the harness phases' child processes: the
    repository on the path, and their compiled bytecode kept under the
    scratch ``root`` (where the environment forbids writing it beside the
    sources, each child would compile torch from source again)."""
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=REPO + (os.pathsep + path if path else ""), **extra)
    env.pop("PYTHONDONTWRITEBYTECODE", None)
    env.setdefault("PYTHONPYCACHEPREFIX", os.path.join(root, ".pycache"))
    return env


@contextlib.contextmanager
def harness_corpora(root):
    """Phases 14-15's corpora, written in the background (host work on
    idle cores) while phases 6-13 run: phase 14's distractors by
    r04_scale30k's own generation command (the driver then skips the step,
    as the script does where the list exists) and phase 15's small
    corpora.  Yields {root: Popen}; every process still running at the
    end of the block is killed."""
    os.makedirs(root, exist_ok=True)
    cmds = {r04_scale30k.DISTRACT_ROOT: r04_scale30k.distractor_corpus(*SCALE_DISTRACT)}
    for at, flags in R05_CORPORA:
        cmds[at] = [sys.executable, "-m", "pfann_tpu_torch.tools.make_synth_corpus",
                    "--root", at, *map(str, flags)]
    procs = {}
    try:
        for at, cmd in cmds.items():
            procs[at] = subprocess.Popen(cmd, cwd=root, env=child_env(root),
                                         stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                                         text=True)
        yield procs
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.wait()


def corpora_done(procs, roots, timeout=600):
    """Wait for the background corpora ``roots``; one that failed fails."""
    for at in roots:
        _, err = procs[at].communicate(timeout=timeout)
        if procs[at].returncode:
            raise AssertionError("corpus %s: exit %d\n%s" % (at, procs[at].returncode,
                                                              err[-2000:]))


def accuracy_lines(stdout, label):
    """{label line: {"exact"|"near"|"song": %}} of a driver's stdout, each
    label (``cover_sub=..``, ``set=..``, ``model=..``) followed by the
    three lines of tools/accuracy.py; a block without its three lines
    fails."""
    acc, at = {}, None
    for line in stdout.splitlines():
        if line.startswith(label):
            at = acc.setdefault(line, {})
            continue
        m = _ACC_LINE.match(line)
        if m and at is not None:
            at[m.group(1).split()[0]] = float(m.group(2))
    bad = [k for k, v in acc.items() if sorted(v) != ["exact", "near", "song"]]
    if not acc or bad:
        raise AssertionError("accuracy blocks without their three lines: %s" % (bad or acc))
    return acc


def matchemb_launches(launch_log, db_dir):
    """The bf16 launches that the matchemb processes serving ``db_dir``
    logged (each line of the launch log carries its process's argv)."""
    n = 0
    with open(launch_log) as fh:
        for line in fh:
            rec = json.loads(line)
            if rec["argv"][0].endswith("matchemb.py") and db_dir in rec["argv"]:
                n += rec["launches"]["bfloat16"]
    return n


def open_db_dir(path, dev, **overrides):
    with open(os.path.join(path, "configs.json")) as fh:
        params = json.load(fh)
    return Database(path, dict(params["indexer"], **overrides), params["hop_size"],
                    dev), params


def scale30k_on_card(dev, card, root, procs, timeout=900):
    """Phase 14: r04_scale30k then r04_scale30k_resume (child processes) on
    phases 12-13's root, with 29,870 distractors of 2 s: the merged DB
    reaches 30,000 songs and Database serves it with the screen by the
    auto path, the {"screen": false} control with the exhaustive engine.
    The auto engine's answers (ids and times) must equal the control's on
    every query of every SNR.  In this process: each DB's engine, the
    share of queries escalated per SNR, and the kernel shapes the phase
    launches (bf16 stage 1 and stage 3 of the screen, the exhaustive
    engine at B=128), held to the plain version and timed.  Phase 15's
    child processes (``flagship_children``) run beside phase 14's: both
    chains spend most of their wall starting processes.  Returns the
    holds' largest bf16 |dbest| and phase 15's children's results."""
    phase(14, "the screen at 30,000 songs: tools.r04_scale30k, tools.r04_scale30k_resume "
              "(and phase 15's child processes beside them)")
    log14 = os.path.join(root, "launches14.jsonl")
    flags = ["--device", dev.type, "--jobs", "2"]
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        children15 = pool.submit(flagship_children, dev, root, procs, timeout)
        corpora_done(procs, [r04_scale30k.DISTRACT_ROOT])
        out, wall = harness_child("r04_scale30k", "tools.r04_scale30k",
                                  ["--distract-songs", str(SCALE_DISTRACT[0]), "--seconds",
                                   str(SCALE_DISTRACT[1]), *flags], root, log14, timeout)
        out2, wall2 = harness_child("r04_scale30k_resume", "tools.r04_scale30k_resume", flags,
                                    root, log14, timeout)
        r15 = children15.result()
    n14 = PATHS["14: r04_scale30k + resume (child processes)"] = child_launches(log14)
    bench = [json.loads(ln) for ln in (out + out2).splitlines() if ln.startswith("{")]
    print("  14 r04_scale30k %.1f s, resume %.1f s; launches (child processes): %s  %s"
          % (wall, wall2, n14, card), flush=True)
    for ln in bench:
        print("  14 BENCH_r04_db30k.json: %s  %s" % (json.dumps(ln), card), flush=True)
    for name, text in (("r04_scale30k", out), ("resume", out2)):
        acc = accuracy_lines(text, "model=")
        for tag in ("synth30k", "alignctl30k"):
            print("  14 %s %-11s song top-1 %% at %s dB: %s" % (
                name, tag, "/".join("%+d" % s for s in SNRS),
                " ".join("%.2f" % acc["model=%s snr=%d" % (tag, s)]["song"] for s in SNRS)),
                flush=True)
    # which engine served which DB: the matchemb processes' bf16 launches
    # (the children's launch log), and Database's own choice
    served = {tag: matchemb_launches(log14, "out/dbs/" + tag)
              for tag in ("synth30k", "alignctl30k")}
    dbs = {}
    for tag in ("synth30k", "alignctl30k"):
        dbs[tag], params = open_db_dir(os.path.join(root, "out", "dbs", tag), dev)
        print("  14 %s: %d songs, %d embeddings, engine %s (%s); matchemb bf16 launches %s"
              % (tag, len(dbs[tag].songList), dbs[tag].ntotal, dbs[tag].engine,
                 "auto" if tag == "synth30k" else '{"screen": false}',
                 served[tag]), flush=True)
    if (len(dbs["synth30k"].songList) != SCALE_SONGS or dbs["synth30k"].engine != "screen"
            or dbs["alignctl30k"].engine != "align"
            or not all(served.values())):
        raise AssertionError("phase 14: want %d songs served by the screen (auto) and the "
                             "control by the exhaustive engine, each with bf16 launches"
                             % SCALE_SONGS)
    for snr in SNRS:
        got = [csv_rows(os.path.join(root, "out", "results", "%s_snr%d_detail.csv"
                                     % (tag, snr))) for tag in ("synth30k", "alignctl30k")]
        if [r[:2] + r[3:4] for r in got[0]] != [r[:2] + r[3:4] for r in got[1]]:
            raise AssertionError("synth30k answers differ from alignctl30k's at %+d dB" % snr)
    print("  14 synth30k (screen, auto) == alignctl30k on every query of every SNR (ids and "
          "times)", flush=True)

    bf16 = torch.bfloat16
    d = params["model"]["d"]
    sets = {snr: query_embeddings_of(os.path.join(root, "out", "qemb", "synth_snr%d" % snr), d)
            for snr in SNRS}
    db = dbs.pop("synth30k")
    shares = []
    with launch_shapes(lambda s: True) as (_, kept):
        for snr in SNRS:
            esc0 = db._align.escalated
            for at in range(0, len(sets[snr]), 128):
                db.query_embeddings_batch(sets[snr][at : at + 128])
            shares.append((db._align.escalated - esc0) / max(len(sets[snr]), 1))
    print("  14 screen at 30,000 songs, share of queries escalated to stage 3 at %s dB: %s"
          % ("/".join("%+d" % s for s in SNRS), " ".join("%.4f" % x for x in shares)),
          flush=True)
    errs = []

    def hold(name, shape, kept):
        dbt, q = kept[shape]
        errs.append(held_launch(name, dbt, q, shape[1], shape[2], shape[4], card)["err"])

    hold("14 bf16 stage 1 at 30,000 songs", next(s for s in kept if s[0] == bf16
                                                 and s[1] == db._align.Rc), kept)
    stage3 = [s for s in kept if s[0] == bf16 and s[1] == db._align.R]
    if not stage3:
        print("  14 no query escalated; stage 3 held with every query escalated", flush=True)
        del db, kept
        db, _ = open_db_dir(os.path.join(root, "out", "dbs", "synth30k"), dev,
                            screen_rescue=2.0)
        with launch_shapes(lambda s: s[0] == bf16 and s[1] == db._align.R) as (_, kept):
            db.query_embeddings_batch(sets[-6][:128])
        stage3 = list(kept)
    hold("14 bf16 stage 3 at 30,000 songs", stage3[0], kept)
    del db, kept
    db = dbs.pop("alignctl30k")
    with launch_shapes(lambda s: s[0] == bf16) as (_, kept):
        db.query_embeddings_batch((sets[-6] + sets[-4])[:128])
    hold("14 bf16 exhaustive at 30,000 songs", next(iter(kept)), kept)
    del db, kept
    torch.cuda.empty_cache()
    return max(errs), r15


def flagship_children(dev, root, procs, timeout):
    """Phase 15's child processes (run beside phase 14's): the train CLI on
    a copy of configs/flagship.json with only ``epoch`` changed (d=128,
    h=1024, u=32), flagship_30kbase built from phase 12's 130-track list,
    then tools.r05_calibrate and tools.r05_flagship through their
    environment (``R05_ENV``).  Returns their outputs, walls, the model's
    widths and the matcher logs that r05_flagship wrote."""
    corpora_done(procs, [at for at, _ in R05_CORPORA])
    log15 = os.path.join(root, "launches15.jsonl")
    with open(os.path.join(REPO, "configs", "flagship.json")) as fh:
        cfg = json.load(fh)
    cfg["epoch"] = R05_EPOCHS
    cfg_path = os.path.join(root, "configs", "flagship_epoch%d.json" % R05_EPOCHS)
    with open(cfg_path, "w") as fh:
        json.dump(cfg, fh, indent=2)
    walls, out = {}, {}
    _, walls["train"] = harness_child("train_flagship", "train",
                                      ["-p", os.path.relpath(cfg_path, root), "-w", "2",
                                       "--device", dev.type], root, log15, timeout)
    _, walls["flagship_30kbase"] = harness_child(
        "build_flagship_30kbase", "builder", ["out/synth_dataset/lists/db.txt",
                                              "out/dbs/flagship_30kbase", "out/models/flagship",
                                              "--device", dev.type], root, log15, timeout)
    flags = ["--device", dev.type, "--jobs", str(HARNESS_JOBS)]
    out["cal"], walls["r05_calibrate"] = harness_child(
        "r05_calibrate", "tools.r05_calibrate", flags, root, log15, timeout, R05_ENV)
    logs = set(glob.glob(os.path.join(root, "logs", "nnmatcher-*.log")))
    out["r5"], walls["r05_flagship"] = harness_child(
        "r05_flagship", "tools.r05_flagship", flags, root, log15, timeout, R05_ENV)
    logs = set(glob.glob(os.path.join(root, "logs", "nnmatcher-*.log"))) - logs
    return dict(out=out, walls=walls, log=log15, model=cfg["model"], matcher_logs=logs)


def flagship_on_card(dev, card, root, r15):
    """Phase 15: round 5 at the flagship's width on small corpora, from
    ``flagship_children``'s results: the trained model's first epoch,
    CALIBRATE_DONE and R05_PIPELINE_DONE, every accuracy block, the engine
    that served the 60 s sets (the matcher's fallback log line and the
    children's launches), and the d=128 launch of the 10 s sets, held to
    the plain version in this process.  Returns the hold's bf16 |dbest|."""
    phase(15, "round 5 at flagship width: tools.r05_calibrate, tools.r05_flagship")
    cal, r5, walls, m = r15["out"]["cal"], r15["out"]["r5"], r15["walls"], r15["model"]
    n15 = PATHS["15: r05_calibrate + r05_flagship (child processes)"] = \
        child_launches(r15["log"])
    print("  15 flagship (d=%d, h=%d, u=%d) trained %d epoch(s): %s" % (
        m["d"], m["h"], m["u"], R05_EPOCHS,
        epoch_metrics(os.path.join(root, "out", "models", "flagship"))), flush=True)
    print("  15 walls (beside phase 14): %s; launches (child processes): %s  %s" % (
        ", ".join("%s %.1f s" % kv for kv in walls.items()), n15, card), flush=True)
    if cal.splitlines()[-1:] != ["CALIBRATE_DONE"] or \
            r5.splitlines()[-1:] != ["R05_PIPELINE_DONE"]:
        raise AssertionError("phase 15: CALIBRATE_DONE / R05_PIPELINE_DONE missing")
    for text, label, n in ((cal, "cover_sub=", 6), (r5, "set=", 16)):
        acc = accuracy_lines(text, label)
        if len(acc) != n:
            raise AssertionError("phase 15: %d %s blocks, want %d" % (len(acc), label, n))
        for k, v in acc.items():
            print("  15 %-22s song %.2f near %.2f exact %.2f" % (k, v["song"], v["near"],
                                                                  v["exact"]), flush=True)
    fallback = set()
    for path in r15["matcher_logs"]:
        with open(path) as fh:
            fallback |= {ln.split("] ", 2)[-1].strip() for ln in fh if "topk fallback" in ln}
    print("  15 60 s sets: %s" % (sorted(fallback) or "no fallback line"), flush=True)
    if n15["bf16"] < 1 or not any("119 windows" in ln for ln in fallback):
        raise AssertionError("phase 15: want bf16 launches (10 s sets) and the 60 s sets "
                             "through the topk fallback (119 windows)")

    # the d=128 launch of the 10 s sets, in this process
    bf16 = torch.bfloat16
    res = os.path.join(root, "out", "results", "smoke_r5_snr-6.txt")
    with contextlib.chdir(root), launch_shapes(lambda s: s[0] == bf16) as (_, kept):
        matcher.main(["matcher", "--batch", "128", "out/queries/r5_snr-6/list.txt",
                      "out/dbs/flagship_r5", res, "--device", dev.type])
    shape = next(iter(kept))
    dbt, q = kept[shape]
    if dbt.shape[1] != 128:
        raise AssertionError("phase 15 launched at d=%d" % dbt.shape[1])
    err = held_launch("15 bf16 exhaustive at d=128 (flagship_r5)", dbt, q, shape[1], shape[2],
                      shape[4], card)["err"]
    del kept, dbt, q
    torch.cuda.empty_cache()
    return err


def norm_close_ulps(got, want, atol=1e-5, chunk=256):
    """Largest |got - want| of two bf16 tensors [n, ...] in units of the
    larger of want's bf16 ulp and atol (1.0: one ulp)."""
    worst = 0.0
    for i in range(0, got.shape[0], chunk):
        g, w = got[i : i + chunk].float(), want[i : i + chunk].float()
        ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(2.0 ** -126))) - 7)
        worst = max(worst, float(((g - w).abs() / ulp.clamp_min(atol)).max()))
    return worst


def norm_act_on_card(dev, card, n=4864, reps=5):
    """Phase 16: the norm_act kernel at the audio batch's 16 volumes (n
    segments of the d=128 encoder, bf16, ReLU after the norm) against its
    plain version, timed beside it and its bound.  Returns {"volumes":
    [...], "ms": the plan's sum, "bound_ms", "plain_ms", "max_ulps"}."""
    phase(16, "norm_act: FpNetwork's norm and activation, kernel vs plain at the audio "
              "batch's 16 norm volumes (%d segments, bf16)" % n)
    tm = time.time()
    lib = norm_act.build()
    print("built %s in %.2f s (cached=%s)  %s" % (
        os.path.relpath(lib, REPO), time.time() - tm, norm_act.build_info["cached"], card))
    report, _ = ptxas_report(norm_act.build_info.get("log", ""))
    for name, line in report:
        print("  ptxas %-40s %s" % (name, line))
    spills = [(nm, ln) for nm, ln in report if re.search(r"[1-9]\d* bytes spill", ln)]
    cfg = {"sample_rate": 8000, "stft_hop": 256, "n_mels": 256, "segment_size": 1,
           "model": {"d": 128, "h": 1024, "u": 32, "fuller": True}}
    shapes = [ln.shape for blk in build_fp_network(cfg).f.blocks for ln in (blk.ln1, blk.ln2)]
    out = dict(volumes=[], ms=0.0, bound_ms=0.0, plain_ms=0.0, max_ulps=0.0)
    gen = torch.Generator(device=dev).manual_seed(16)
    for shape in shapes:
        V = int(np.prod(shape))
        w = 1 + 0.2 * torch.randn(shape, generator=gen, device=dev)
        b = 0.1 * torch.randn(shape, generator=gen, device=dev)
        x = torch.randn((n, *shape), generator=gen, device=dev, dtype=torch.bfloat16) * 1.7 + 0.3
        want = norm_act.norm_act_reference(x, w, b, 1e-5, "ReLU", True)
        got = norm_act.norm_act(x.clone(), w, b, 1e-5, "ReLU", True)
        ulps = norm_close_ulps(got, want)
        if ulps > 1.0:
            raise AssertionError("norm_act at %s: %.2f ulps from the plain version"
                                 % (shape, ulps))
        del want, got
        y = x.clone()
        k_ms = time_ms(lambda: norm_act.norm_act(y, w, b, 1e-5, "ReLU", True), reps)
        p_ms = time_ms(lambda: norm_act.norm_act_reference(x, w, b, 1e-5, "ReLU", True),
                       max(1, reps // 2))
        bound_ms = (n * V * 4 + V * 8) / HBM_BYTES_S * 1e3
        plan = norm_act.plan(V, 2)
        row = dict(shape=list(shape), V=V, plan=plan, ms=k_ms, plain_ms=p_ms,
                   bound_ms=bound_ms, ulps=ulps)
        print("  %-16s V %7d: kernel %8.3f ms  plain %8.3f ms  bound %7.3f ms (bytes)  "
              "%5.1f%% of bound  %.2f ulps  plan %s  %s" % (
                  tuple(shape), V, k_ms, p_ms, bound_ms, 100 * bound_ms / k_ms, ulps, plan,
                  card), flush=True)
        out["volumes"].append(row)
        out["ms"] += k_ms
        out["plain_ms"] += p_ms
        out["bound_ms"] += bound_ms
        out["max_ulps"] = max(out["max_ulps"], ulps)
        del x, y
    torch.cuda.empty_cache()
    print("  norm_act over the batch's 16 volumes: kernel %.3f ms, plain %.3f ms, bound %.3f ms "
          "(%.1f%% of bound), max %.2f ulps  %s" % (
              out["ms"], out["plain_ms"], out["bound_ms"], 100 * out["bound_ms"] / out["ms"],
              out["max_ulps"], card), flush=True)
    if spills:  # after the timings, which show what a spill costs
        raise AssertionError("norm_act instantiations spill: %s" % spills)
    return out


def csv_rows(path):
    with open(path) as fh:
        return list(csv.reader(fh))


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
    # the native C++ core (g++, phase 7's reference and cppmatcher's
    # binary) builds beside nvcc
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        native_builds = [pool.submit(native.lib_path), pool.submit(native.matcher_binary)]
        lib = align_kernel.build()
        print("built %s in %.2f s (cached=%s)  %s" % (
            os.path.relpath(lib, REPO), time.time() - tm, align_kernel.build_info["cached"],
            card))
        for fut in native_builds:
            print("built %s (g++) by %.2f s  %s" % (os.path.relpath(fut.result(), REPO),
                                                     time.time() - tm, card))
    report, serial = ptxas_report(align_kernel.build_info.get("log", ""))
    for name, line in report:
        print("  ptxas %-28s %s" % (name, line))
    # every instantiation keeps its tiles in registers: no spills (a spilled
    # wgmma accumulator is also a hazard, the product writing it being
    # asynchronous), and ptxas leaves the wgmma groups in flight
    spills = [(n, ln) for n, ln in report if re.search(r"[1-9]\d* bytes spill (stores|loads)", ln)]
    if spills:
        raise AssertionError("instantiations spill: %s" % spills)
    if serial:
        raise AssertionError("ptxas serialised the wgmma of %s" % serial)
    sass = sass_counts(lib)
    if sass is None:
        print("  no cuobjdump in this toolkit: SASS not counted")
    else:
        for name, c in sorted(sass.items()):
            print("  SASS %-18s %s" % (name, dict(c)))
        # bf16 on HGMMA and int8 on IGMMA (wgmma), none on mma.sync
        for tag, op in (("bf16", "HGMMA"), ("int8", "IGMMA")):
            inst = {n: c for n, c in sass.items() if n.startswith(tag)}
            if not inst or any(c[op] == 0 or c["HMMA"] or c["IMMA"] for c in inst.values()):
                raise AssertionError("%s instantiations without %s or with HMMA/IMMA: %s"
                                     % (tag, op, inst))
        # f32 is FFMA on the CUDA cores, never the tensor cores (TF32)
        inst = {n: c for n, c in sass.items() if n.startswith("f32")}
        if not inst or any(c["FFMA"] == 0 or sum(c[op] for op in ("HMMA", "HGMMA"))
                           for c in inst.values()):
            raise AssertionError("f32 instantiations: %s" % inst)

    # ---------------------------------------------------------------- 3
    phase(3, "kernel vs plain on the card")
    max_err = 0.0  # bf16
    f32_err = 0.0
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
                    err, nbad, _, _ = compare(db, q, R, S, len(counts))
                    if dtype == torch.float32:
                        f32_err = max(f32_err, err)
                    else:
                        max_err = max(max_err, err)
                    k_ms = time_ms(lambda: align_reduce(db, q, R, S, len(counts)), 3)
                    p_ms = time_ms(
                        lambda: align_reduce_reference(db, q, R, S, len(counts)), 1)
                    lib_ms = conv_library_ms(db, q, R, S, len(counts), 3)
                    bnd = bound(dtype, db.shape[0], d, S, B, len(counts), R)
                    print("  %-8s pad %3d S %3d B %4d: kernel %9.3f ms  plain %9.3f ms"
                          "  conv1d %8.3f ms  %s  max|dbest| %.2e  argoff ties %d  %s" % (
                              str(dtype).split(".")[1], pad, S, B, k_ms, p_ms, lib_ms,
                              fmt_bound(bnd), err, nbad, card), flush=True)
            del db
    torch.cuda.empty_cache()
    print("  f32 max|dbest| phase 3: %.3e" % f32_err, flush=True)
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
                lib_ms = int_mm_library_ms(c8, q, 3)
                bnd = bound(torch.int8, c8.shape[0], d, Sc, B, n_pad, Rc)
                print("  int8     pad %3d Sc %3d B %4d: kernel %9.3f ms  plain %9.3f ms"
                      "  _int_mm products %8.3f ms  %s  bitwise equal  %s" % (
                          pad, Sc, B, k_ms, p_ms, lib_ms, fmt_bound(bnd), card), flush=True)
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
    err, nbad, (kb4, _), _ = compare(engine._db, q, engine.R, S, n_songs)
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
    err32, nbad32, _, _ = compare(engine._db, qb, engine.R, S, n_songs)
    max_err = max(max_err, err32)
    k32 = time_ms(lambda: align_reduce(engine._db, qb, engine.R, S, n_songs), 5)
    p32 = time_ms(lambda: align_reduce_reference(engine._db, qb, engine.R, S, n_songs), 3)
    align_kernel.REFERENCE_SCORE_BYTES = 1 << 30
    plain_ms = min(plain_by_cap.values())
    library_ms = conv_library_ms(engine._db, q, engine.R, S, n_songs, 3)
    lib32 = conv_library_ms(engine._db, qb, engine.R, S, n_songs, 5)
    bound_4 = bound(torch.bfloat16, engine._db.shape[0], d, S, B, n_songs, engine.R)
    bound32 = bound(torch.bfloat16, engine._db.shape[0], d, S, 32, n_songs, engine.R)
    flops = 2.0 * n_songs * engine.R * d * S * B
    print("  kernel %.4f s/batch = %.1f queries/s (%.1f TFLOP/s of bf16 work); "
          "plain %.4f s/batch (1 GiB chunks) %.4f s/batch (16 GiB chunks) = %.1f "
          "queries/s at the faster; conv1d %.4f s/batch; %s; vs plain max|dbest| %.2e, "
          "argoff ties %d  %s" % (
              kernel_ms / 1e3, B / (kernel_ms / 1e3), flops / kernel_ms / 1e9,
              plain_by_cap[1 << 30] / 1e3, plain_by_cap[16 << 30] / 1e3,
              B / (plain_ms / 1e3), library_ms / 1e3, fmt_bound(bound_4), err, nbad, card),
          flush=True)
    print("  B=32: kernel %.3f ms, plain %.3f ms (one chunk), conv1d %.3f ms, %s; vs plain "
          "max|dbest| %.2e, argoff ties %d  %s" % (
              k32, p32, lib32, fmt_bound(bound32), err32, nbad32, card), flush=True)
    # phase 10 serves the same batch sharded: its answers, and which of them
    # clear the runner-up song by more than the kernel's own tolerance
    top2 = torch.from_numpy(kb4).topk(2).values
    p4 = dict(emb=emb, f=f, src=src, off=off, song=song, t=t, ms=kernel_ms,
              clear=((top2[:, 0] - top2[:, 1]) > BEST_ATOL).numpy())
    del engine, q, qb, top2, kb4  # the corpus serves phase 7 as a DB directory
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
        norm_act.launches = 0
        tm = time.time()
        builder.main(["builder", lst, db_dir, model_dir, "--device", "cuda"])
        build_s = time.time() - tm
        tm = time.time()
        matcher.main(["matcher", qlist, db_dir, res, "--device", "cuda"])
        matcher.main(["matcher", qlist, db_dir, res1, "--top1", "--device", "cuda"])
        torch.cuda.synchronize()
        match_s = time.time() - tm
        path5 = record("5: builder + matcher x2, align engine")
        path5["norm_act"] = norm_act.launches
        launches = path5["bf16"]
        print("  builder %.2f s, matcher x2 %.2f s, kernel launches %d, norm_act launches %d"
              "  %s" % (build_s, match_s, launches, path5["norm_act"], card))
        if launches <= 0:
            raise AssertionError("the main path never launched the kernel")
        if path5["norm_act"] <= 0:
            raise AssertionError("the main path never launched the norm_act kernel")

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
        err, nbad, (kb, _), _ = compare(eng._db, qf, eng.R, qf.shape[1], eng.n_songs)
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
        record("5: matcher x2, screened engine")
        launches_int8 = launched(torch.int8)
        screen_bf16 = launched(torch.bfloat16)
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

        # phases 14-15's corpora are written in the background from here on
        with tempfile.TemporaryDirectory(prefix="chip_smoke_harness_") as root12, \
                harness_corpora(root12) as corpora:
            shot = screen_scenario(dev, card)
            max_err = max(max_err, shot["bf16_err"])
            p5 = dict(qlist=qlist, db_dir=db_dir, tsv=res, truth=truth, lst=lst)
            big, p6 = shot.pop("corpus"), shot.pop("answers")
            f1 = rest_of_serving(dev, card, tmp, emb, big, p5)
            landmark_front_end(dev, card, tmp, p5)
            with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp9:
                synth = training_on_card(dev, card, tmp9)
                errs10 = multi_gpu_paths(dev, card, tmp9, big, p4, p6, synth)
                del big, p4, p6  # phase 11 builds its own 30k-song corpora
                err11 = ported_bench(dev, card, os.path.join(tmp, "db10k"),
                                     os.path.join(tmp9, "train.json"))
            errs12 = harness_on_card(dev, card, root12)
            err14, r15 = scale30k_on_card(dev, card, root12, corpora)
            err15 = flagship_on_card(dev, card, root12, r15)
    max_err = max(max_err, errs10["bf16"], err11, errs12["bf16"], err14, err15)
    na16 = norm_act_on_card(dev, card)

    # every driven path's launches, phases 5-7 (0 where a path runs none)
    launches = sum(p["bf16"] for p in PATHS.values())
    launches_int8 = sum(p["int8"] for p in PATHS.values())
    launches_f32 = sum(p["f32"] for p in PATHS.values())
    f32_shapes = [f1[1024], f1[32], shot["f32"]["f2"], shot["f32"]["f3"]]
    f32_err = max([f32_err] + [x["err"] for x in f32_shapes])
    for path in ("7f1: db_dtype float32, exhaustive engine, B=1024",
                 "6: f32 screened engine, clean batch", "6: f32 screened engine, noisy batch"):
        if PATHS[path]["f32"] < 1:
            raise AssertionError("%s launched no f32 kernel" % path)
    ends = [*list(PHASE_START.values())[1:], time.perf_counter()]
    print("wall s per phase: %s  %s" % (", ".join(
        "%d: %.1f" % (n, e - t0) for (n, t0), e in zip(PHASE_START.items(), ends)), card),
        flush=True)
    print(json.dumps({"kernels": [{
        "name": "align_reduce",
        "route": "cuda",
        "source": "pfann_tpu_torch/csrc/align_reduce.cu",
        "replaces": "pfann_tpu/index/pallas_align.py:45",
        "launches": launches,
        "launches_by_path": {k: v["bf16"] for k, v in PATHS.items()},
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_4[0],
        "bound_by": bound_4[1],
        "library_ms": library_ms,
    }, {
        "name": "align_reduce_int8",
        "route": "cuda",
        "source": "pfann_tpu_torch/csrc/align_reduce.cu",
        "replaces": "pfann_tpu/index/pallas_align.py:49",
        "launches": launches_int8,
        "launches_by_path": {k: v["int8"] for k, v in PATHS.items()},
        "max_abs_err": max(int8_err, shot["max_abs_err"], errs10["int8"], errs12["int8"]),
        "ms": shot["ms"],
        "plain_ms": shot["plain_ms"],
        "bound_ms": shot["bound"][0],
        "bound_by": shot["bound"][1],
        "library_ms": shot["library_ms"],
    }, {
        "name": "align_reduce_f32",
        "route": "cuda",
        "source": "pfann_tpu_torch/csrc/align_reduce.cu",
        "replaces": "pfann_tpu/index/pallas_align.py:45",
        "launches": launches_f32,
        "launches_by_path": {k: v["f32"] for k, v in PATHS.items()},
        "max_abs_err": f32_err,
        "ms": f1[1024]["ms"],
        "plain_ms": f1[1024]["plain_ms"],
        "bound_ms": f1[1024]["bound"][0],
        "bound_by": f1[1024]["bound"][1],
        "library_ms": f1[1024]["library_ms"],
    }, {
        "name": "norm_act",
        "route": "cuda",
        "source": "pfann_tpu_torch/csrc/norm_act.cu",
        "replaces": None,
        "launches": sum(p.get("norm_act", 0) for p in PATHS.values()),
        "launches_by_path": {k: v["norm_act"] for k, v in PATHS.items() if "norm_act" in v},
        "max_ulps": na16["max_ulps"],
        "ms": na16["ms"],
        "plain_ms": na16["plain_ms"],
        "bound_ms": na16["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
