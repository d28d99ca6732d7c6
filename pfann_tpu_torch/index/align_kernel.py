"""The align-reduce kernel: build, ctypes binding, wrapper, plain version.

``align_reduce`` is the port of the TPU kernel ``pallas_alignment_reduce``
(``pfann_tpu/index/pallas_align.py:84-129``), in f32, bf16 and int8 (int32
sums, ``pallas_align.py:49-52``).  On a CUDA tensor it launches the
hand-written kernel of ``csrc/align_reduce.cu`` (or raises); on a CPU
tensor it runs ``align_reduce_reference``, the plain PyTorch version
beside it.  There is no fallback from the kernel to the plain version.

bf16 and int8 run on the tensor cores (``wgmma`` fed by TMA), f32 on the
CUDA cores (FFMA in round-to-nearest f32, no TF32); all three are the same
GEMM over layout rows.  ``tile_plan`` works out each launch's plan (query
tile, instantiation, songs per work item, stages, shared memory, grid)
here, where a CPU test can check it, and the kernel checks the plan it is
given.  TMA reads 16-byte aligned rows: the wrapper pads d with zero
columns where a row is not a multiple of 16 bytes.

The kernel is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface at first use, under ``pfann_tpu_torch/_build/``,
keyed by a hash of the source and the flags, and loaded with ctypes.
"""

from __future__ import annotations

import atexit
import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "align_reduce.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
BUILD_PARTS = 4  # ALIGN_REDUCE_PART 0-3 of the source, one nvcc each
_DTYPES = (torch.float32, torch.bfloat16, torch.int8)
# the plain version chunks queries so its [N, S, chunk] score tensor (f32,
# or f64 for int8) stays under this many bytes
REFERENCE_SCORE_BYTES = 1 << 30
# an int8 row sum of S*d products (each at most 128^2) must fit the
# kernel's int32 accumulator
INT8_MAX_SD = (2**31 - 1) // (128 * 128)

# The kernel's tiles (csrc/align_reduce.cu: namespace wg for bf16 and int8,
# launch_f32 for f32).
SMEM_LIMIT = 232_448  # shared memory a block may use on sm_90 (227 KB)
SM_SMEM = 233_472  # shared memory of one SM (228 KB), 1 KB of it kept per block
SMS = 132  # streaming multiprocessors of an H100 SXM
# TN, queries per block (f32) or work item (bf16, int8; bf16 adds 128)
QUERY_TILES = (8, 16, 32, 64)
# bf16 and int8 (wgmma): NWG consumer warpgroups of 128 threads, each MT
# m64 tiles of an M-subtile of TM = 64 * MT * NWG layout rows, and one
# warpgroup whose one thread issues the TMA loads; a persistent grid of
# BPS blocks per SM.
PANEL = 128  # bytes of a row of a 128-byte swizzled column panel
BOX_MAX = 256  # rows of a TMA box at most
# The plans' instantiations, in order of preference: (rowsum, NWG, MT,
# ping-pong accumulators, BPS, query tiles), for bf16 summing each window
# row chained or apart (rowsum; S*d > CHAIN_MAX_SD), and for int8.  The
# smallest tile of any that holds B is taken.  bf16 from 64 queries takes
# 128-query tiles in 128-row subtiles (shared memory traffic per operation
# falls with the query tile: PERF.md, csrc/align_reduce.cu), and below 64
# queries 256-row subtiles, so each staged query row feeds 256 layout rows.
# The row sums' three accumulators leave room for one m64 tile a
# warpgroup, so wide rows whose stages do not fit otherwise take that form
# too.  int8 runs three blocks an SM of one consumer warpgroup each (one
# block's epilogue, long beside stage 1's 20 K-steps a subtile, runs under
# the others' products), its query tile resident where it fits; past d =
# 1536 one block an SM.
TILE_CONFIGS = {
    (2, False): ((False, 2, 2, False, 1, (8, 16, 32)), (False, 2, 1, False, 1, (64, 128)),
                 (True, 2, 1, False, 1, QUERY_TILES)),
    (2, True): ((True, 2, 1, False, 1, QUERY_TILES),),
    (1, False): ((False, 1, 1, False, 3, QUERY_TILES), (False, 1, 1, False, 1, (8,))),
}
# further instantiations, for tools/torch_kernel_sweep.py: (itemsize,
# rowsum, NWG, MT, ping-pong, blocks per SM, TN): bf16 and int8 in 128-row
# subtiles with ping-pong accumulators at 64 queries, one block an SM, and
# int8 at 128 queries without
WGMMA_VARIANTS = {(2, False, 2, 1, True, 1, 64), (1, False, 2, 1, True, 1, 64),
                  (1, False, 2, 1, False, 1, 128), (1, False, 1, 1, False, 2, 64)}
# every instantiation the source builds (wg::built there)
WGMMA_BUILT = WGMMA_VARIANTS | {
    (item, rs, nwg, mt, pp, bps, tn) for (item, _), cfgs in TILE_CONFIGS.items()
    for rs, nwg, mt, pp, bps, tiles in cfgs for tn in tiles}
QUERY_RING = 4  # query-row stages of a streaming plan (2 where shared memory is short)
# f32, (TM, threads) at every TN: lanes of 8 rows x 8 queries (fewer
# queries below 64), so a K-step of 4 floats is 16 shared loads for 256
# FMAs.  128 queries a block (in 128-row subtiles) ran 3% slower than 64
# at the f32 serving shapes (tools/torch_kernel_sweep.py)
F32_TILE = (256, 256)
MAX_GROUP = 64  # songs per block
QUERY_STAGES = 2  # f32's ring of query-row stages (NST)
# bf16 chains all S*d/16 MMAs of a sum into one accumulator up to this
# S*d; past it each window row is summed apart (see tile_plan's rowsum)
CHAIN_MAX_SD = 4096
SEGMAX_BYTES = 16_384  # at most this much shared memory holds the per-song maxima

_lib = None
build_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the align-reduce kernel cannot be built")


def build() -> str:
    """Compile csrc/align_reduce.cu (once per source hash); returns the
    library path.  The source's parts (ALIGN_REDUCE_PART: the f32 entry,
    bf16 chained, bf16 with row sums, int8) compile in parallel, one nvcc
    each, and link into one library.  A failed nvcc raises with its
    stderr."""
    with open(SOURCE, "rb") as f:
        src = f.read()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = os.path.join(BUILD_DIR, "libalign_reduce_%s.so" % key)
    if os.path.exists(lib_path):
        build_info.update(path=lib_path, seconds=0.0, cached=True)
        return lib_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.tmp" % (lib_path, os.getpid())
    tm = time.time()
    nvcc = _nvcc()
    objs = ["%s.%d.o" % (tmp, part) for part in range(BUILD_PARTS)]
    procs = [subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-c", "-DALIGN_REDUCE_PART=%d" % part, "-o", obj, SOURCE],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for part, obj in enumerate(objs)]
    logs = [p.communicate()[1] for p in procs]
    try:
        for p, log in zip(procs, logs):
            if p.returncode != 0:
                raise RuntimeError("nvcc failed (exit %d) building %s:\n%s"
                                   % (p.returncode, SOURCE, log))
        link = subprocess.run([nvcc, "-shared", "-o", tmp, *objs], capture_output=True,
                              text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc failed (exit %d) linking %s:\n%s"
                               % (link.returncode, SOURCE, link.stderr))
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(tmp, lib_path)
    build_info.update(path=lib_path, seconds=time.time() - tm, cached=False,
                      log="".join(logs))
    return lib_path


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        ptrs = [ctypes.c_void_p] * 4
        lib.align_reduce_f32_launch.argtypes = [
            *ptrs, ctypes.c_longlong, *[ctypes.c_int] * 11, ctypes.c_longlong, ctypes.c_void_p]
        wgmma = (lib.align_reduce_bf16_launch, lib.align_reduce_bf16_rowsum_launch,
                 lib.align_reduce_int8_launch)
        for fn in wgmma:
            fn.argtypes = [*ptrs, ctypes.c_longlong, *[ctypes.c_int] * 16, ctypes.c_longlong,
                           ctypes.c_void_p]
        for fn in (lib.align_reduce_f32_launch, *wgmma):
            fn.restype = ctypes.c_int
        lib.align_reduce_error_string.argtypes = [ctypes.c_int]
        lib.align_reduce_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _song_group(R: int, tm: int, tn: int, n_songs: int, n_qtiles: int,
                resident: int = 0) -> int:
    """Songs per block: the fewest rows wasted rounding G*R up to a whole
    number of TM-row subtiles (ties to the larger G), with G*R at most 8
    subtiles or 2 songs (songs of more than 4 subtiles: int8's 64-row
    subtiles, whose items would otherwise own one song a piece), the
    per-song maxima under SEGMAX_BYTES, and at least two
    blocks per SM where the DB has that many songs.  With ``resident``
    (the blocks the card runs at once), the waste also counts the last,
    partly filled wave of blocks: f32 runs one block per SM, and at phase
    3's 1,000 songs 5 songs a block (25 waves of 3,200 blocks) ran 2-4%
    faster than 10 (13 waves of 1,600; tools/torch_kernel_sweep.py)."""
    hi = min(MAX_GROUP, SEGMAX_BYTES // (8 * tn), max(2, 8 * tm // R), n_songs,
             max(1, n_songs * n_qtiles // (2 * SMS)))

    def rows(g):
        return -(-g * R // tm) * tm / (g * R)

    def cost(g):  # rows, and the wave: costs within 1% count as equal
        blocks = -(-n_songs // g) * n_qtiles
        return round(rows(g) * -(-blocks // resident) * resident / blocks, 2)

    return min(range(1, max(1, hi) + 1),
               key=lambda g: (cost(g) if resident else 0, rows(g), -g))


def row_stride(d: int, itemsize: int) -> int:
    """f32's bytes between staged rows: the row rounded up to its K-step
    (16 bytes, a float4), plus 16."""
    return -(-d * itemsize // 16) * 16 + 16


def smem_bytes(d: int, itemsize: int, tm: int, tn: int, G: int, sc: int,
               abuf: int) -> int:
    """f32's dynamic shared memory (smem_bytes in the source): abuf A
    stages of tm + sc - 1 rows, QUERY_STAGES query-row stages of tn rows,
    and two 32-bit words per (song of the group, query)."""
    lds = row_stride(d, itemsize)
    return abuf * (tm + sc - 1) * lds + QUERY_STAGES * tn * lds + G * tn * 8


def padded_width(d: int, itemsize: int) -> int:
    """d rounded up so that a row is a multiple of 16 bytes, as TMA needs
    (bf16 and int8; the wrapper pads with zero columns)."""
    return -(-d * itemsize // 16) * 16 // itemsize


def tma_boxes(tm: int, sc: int) -> tuple[int, int]:
    """(boxes, rows a box) of an A stage of tm + sc - 1 rows: at most
    BOX_MAX rows a box, a multiple of 8 (the swizzle's row phase)."""
    rows = tm + sc - 1
    n_box = -(-rows // BOX_MAX)
    per_box = -(-rows // n_box)
    return n_box, -(-per_box // 8) * 8


def wgmma_smem_bytes(d: int, itemsize: int, tm: int, tn: int, G: int, sc: int, abuf: int,
                     qs: int) -> int:
    """Dynamic shared memory of a bf16/int8 plan (wg::smem_bytes in the
    source): 1 KB to align the stages to the swizzle's 1,024-byte atom,
    abuf A stages and qs query-row stages of 128-byte column panels, two
    32-bit words per (song of the group, query), two mbarriers a stage."""
    kb = -(-padded_width(d, itemsize) * itemsize // 32) * 32  # the row in K-steps
    panels = -(-kb // PANEL)
    n_box, box_rows = tma_boxes(tm, sc)
    return (1024 + abuf * panels * n_box * box_rows * PANEL + qs * panels * tn * PANEL
            + 8 * G * tn + 16 * (abuf + qs))


def _f32_plan(B, S, d, R, n_songs):
    lds = row_stride(d, 4)
    want = next(t for t in QUERY_TILES if t >= min(B, QUERY_TILES[-1]))
    for tn in sorted((t for t in QUERY_TILES if t <= want), reverse=True):
        tm, threads = F32_TILE
        n_qtiles = -(-B // tn)
        G = _song_group(R, tm, tn, n_songs, n_qtiles, SMS)

        def smem(sc, abuf):
            return smem_bytes(d, 4, tm, tn, G, sc, abuf)

        fit = [(S, a) for a in (2, 1) if smem(S, a) <= SMEM_LIMIT]
        if not fit:
            sc = (SMEM_LIMIT - QUERY_STAGES * tn * lds - G * tn * 8) // lds - tm + 1
            fit = [(min(sc, S), 1)] if sc >= 1 else []
        if fit:
            sc, abuf = fit[0]
            return dict(tn=tn, tm=tm, threads=threads, rowsum=False, G=G, sc=sc,
                        abuf=abuf, smem=smem(sc, abuf), grid=(-(-n_songs // G), n_qtiles))
    raise ValueError("align_reduce: no tile plan fits %d bytes of shared memory "
                     "(d=%d, itemsize 4)" % (SMEM_LIMIT, d))


def wgmma_plan(B: int, S: int, d: int, itemsize: int, R: int, n_songs: int, *,
               config: tuple | None = None, tn: int | None = None,
               qs: int | None = None) -> dict:
    """The bf16 (itemsize 2) / int8 (1) plan (see :func:`tile_plan`).
    ``config`` (rowsum, NWG, MT, ping-pong, blocks per SM), ``tn`` and
    ``qs`` override the defaults for tools/torch_kernel_sweep.py."""
    chain = not (itemsize == 2 and S * d > CHAIN_MAX_SD)
    configs = TILE_CONFIGS[(itemsize, not chain)]
    if config is not None:
        configs = (config + (configs[0][-1] if tn is None else (tn,),),)
    tiles = sorted({t for *_, ts in configs for t in ts})
    want = tn or next(t for t in tiles if t >= min(B, tiles[-1]))
    for t in sorted((t for t in tiles if t <= want), reverse=True):
        for rowsum, nwg, mt, pp, bps, ts in configs:
            plan = t in ts and _wgmma_fit(B, S, d, itemsize, R, n_songs, rowsum, nwg, mt, pp,
                                          bps, t, qs)
            if plan:
                return plan
    raise ValueError("align_reduce: no tile plan fits %d bytes of shared memory "
                     "(d=%d, itemsize %d)" % (SMEM_LIMIT, d, itemsize))


def _wgmma_fit(B, S, d, itemsize, R, n_songs, rowsum, nwg, mt, pp, bps, tn, qs):
    tm = 64 * mt * nwg
    n_qtiles = -(-B // tn)
    G = _song_group(R, tm, tn, n_songs, n_qtiles)
    limit = min(SMEM_LIMIT, SM_SMEM // bps - 1024)

    def smem(sc, abuf, q):
        return wgmma_smem_bytes(d, itemsize, tm, tn, G, sc, abuf, q)

    # (query stages, resident, A stages): the query tile resident where it
    # fits, else a ring of QUERY_RING (2 where shared memory is short)
    opts = [(qs, qs == S, 2)] if qs else (
        [(S, True, 2), (QUERY_RING, False, 2), (2, False, 2), (2, False, 1)])
    fit = [(q, res, a, S) for q, res, a in opts
           if (res or q >= 2) and smem(S, a, q) <= limit]
    if not fit and not qs:  # split the window rows into chunks, each restaging A
        sc = next((c for c in range(S - 1, 0, -1) if smem(c, 1, 2) <= limit), 0)
        fit = [(2, False, 1, sc)] if sc else []
    if not fit:
        return None
    q, res, abuf, sc = fit[0]
    n_box, box_rows = tma_boxes(tm, sc)
    grid = (-(-n_songs // G), n_qtiles)
    return dict(tn=tn, tm=tm, nwg=nwg, mt=mt, pp=pp, bps=bps, threads=128 * (nwg + 1),
                rowsum=rowsum, G=G, sc=sc, abuf=abuf, qs=q, resident=res, n_box=n_box,
                box_rows=box_rows, smem=smem(sc, abuf, q), grid=grid,
                blocks=min(grid[0] * grid[1], SMS * bps))


def tile_plan(B: int, S: int, d: int, itemsize: int, R: int, n_songs: int) -> dict:
    """The kernel's plan for f32 (itemsize 4), bf16 (2) or int8 (1).

    bf16 and int8 (wgmma):
    tn       queries per work item: the smallest of the dtype's query tiles
             (TILE_CONFIGS) that holds B (items of the largest past it);
    rowsum   bf16 only: each window row's products sum apart and are
             added with round-to-nearest f32 adds, where S*d > CHAIN_MAX_SD
             (the tensor cores' f32 accumulation rounds toward zero, so one
             chain over S = 119 rows of d = 128 drifts 2.3e-3) or where
             the chained form's stages do not fit;
    nwg, mt, pp, bps  consumer warpgroups, m64 tiles a warpgroup (tm =
             64 * mt * nwg layout rows an M-subtile), ping-pong
             accumulators and blocks per SM, and ``threads``
             (TILE_CONFIGS);
    G        songs per work item (``_song_group``);
    qs, resident  query-row stages: the tile's S rows for the whole item
             where they fit beside two A stages, else a ring of QUERY_RING
             or 2;
    sc, abuf window rows per A stage (S unless S*d outgrows shared memory)
             and A stages (2, or 1 where shared memory is short);
    n_box, box_rows  TMA boxes of an A stage of tm + sc - 1 rows;
    smem     bytes of dynamic shared memory, within a block's share of the
             SM (SMEM_LIMIT at one block);
    grid     (song groups, query tiles): the work items, song group fastest;
    blocks   the persistent grid: bps blocks per SM, at most one per item.

    f32 (CUDA cores): tn (QUERY_TILES), tm and threads (F32_TILE), G, sc,
    abuf (2 where they fit), smem and grid, one block per (song group,
    query tile); its query rows stream through a ring of QUERY_STAGES."""
    if itemsize == 4:
        return _f32_plan(B, S, d, R, n_songs)
    return wgmma_plan(B, S, d, itemsize, R, n_songs)


def copy_bytes(row_bytes: int, *ptrs: int) -> int:
    """The kernel's cp.async width: the largest of 16, 8, 4 bytes dividing
    the row bytes and every pointer (0: none does)."""
    for ch in (16, 8, 4):
        if row_bytes % ch == 0 and all(p % ch == 0 for p in ptrs):
            return ch
    return 0


def zero_extended(
    x: torch.Tensor, rows: int, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """x[:rows] in ``dtype``, with zero rows appended up to ``rows`` (the
    kernel reads rows >= N as zero)."""
    x = x[:rows].to(dtype)
    if x.shape[0] < rows:
        x = torch.cat([x, x.new_zeros(rows - x.shape[0], *x.shape[1:])])
    return x


def reduce_per_song(align: torch.Tensor, n_songs: int, R: int):
    """align [n_songs*R, n] -> (best [n, n_songs] f32, argoff [n, n_songs]
    int32): the per-song max over offsets and the LAST offset reaching it
    (``pallas_align.py:73-75``), written as the two-pass form because
    torch.max(dim) does not promise which index it returns on ties."""
    align = align.view(n_songs, R, align.shape[1])
    best = align.amax(dim=1)
    offs = torch.arange(R, dtype=torch.int32, device=align.device).view(1, R, 1)
    argoff = torch.where(align >= best[:, None], offs, -1).amax(dim=1)
    return best.T, argoff.T


def align_reduce_reference(
    db: torch.Tensor, queries: torch.Tensor, R: int, S: int, n_songs: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: matmul to [N, S, B] (chunked
    over B), the diagonal sum over window rows, then the per-song max and
    last-index argmax.  Same contract as :func:`align_reduce`.  Float
    inputs compute in f32; int8 inputs in f64, where every product and sum
    of int8 values is an exact integer (an f32 sum stops being exact past
    2^24), so best and argoff equal the kernel's int32 ones bit for bit."""
    return window_reduce(db, queries, R, S, n_songs)


def window_reduce(
    db: torch.Tensor, queries: torch.Tensor, R: int, S: int, n_songs: int,
    window=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version's steps, with a hook: ``window(i, ip, batch)``
    (optional) maps window row i's inner products ip [n_songs*R, n], for
    the queries ``batch`` (a slice of B), to what that row adds to the sum.
    The kernel has no such hook; the score_alpha path (``index/align.py``)
    runs through this on any device."""
    d = db.shape[1]
    B = queries.shape[0]
    N0 = n_songs * R
    need = N0 + S - 1
    acc = torch.float64 if db.dtype == torch.int8 else torch.float32
    dbf = zero_extended(db, need, acc)
    best = torch.empty(B, n_songs, dtype=torch.float32, device=db.device)
    argoff = torch.empty(B, n_songs, dtype=torch.int32, device=db.device)
    chunk = max(1, REFERENCE_SCORE_BYTES // max(need * S * dbf.element_size(), 1))
    for b0 in range(0, B, chunk):
        q = queries[b0 : b0 + chunk].to(acc)
        n = q.shape[0]
        scores = (dbf @ q.permute(2, 1, 0).reshape(d, S * n)).view(need, S, n)
        align = None
        for i in range(S):
            ip = scores[i : N0 + i, i]
            if window is not None:
                ip = window(i, ip, slice(b0, b0 + n))
            align = ip if align is None else align + ip
        best[b0 : b0 + n], argoff[b0 : b0 + n] = reduce_per_song(align, n_songs, R)
    return best, argoff


def _tma_aligned(db: torch.Tensor, queries: torch.Tensor):
    """db and queries as TMA reads them: rows a multiple of 16 bytes (d
    padded with zero columns, which add nothing to the sums) and bases
    16-byte aligned (a fresh copy where a view starts off it)."""
    d = db.shape[1]
    dp = padded_width(d, db.element_size())
    if dp != d:
        return (torch.nn.functional.pad(db, (0, dp - d)),
                torch.nn.functional.pad(queries, (0, dp - d)))
    return tuple(t if t.data_ptr() % 16 == 0 else t.clone() for t in (db, queries))


def align_reduce(
    db: torch.Tensor, queries: torch.Tensor, R: int, S: int, n_songs: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """db [N, d] uniform layout (rows >= N read as zero), queries [B, S, d]
    of db's dtype (f32, bf16 or int8).  Returns (best [B, n_songs] f32,
    argoff [B, n_songs] int32): the per-song max over offsets o in [0, R)
    of sum_i db[s*R + o + i] . q[b, i], and the largest o reaching it.
    int8 sums are exact int32 values, converted to f32 at the end.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if db.device.type == "cpu" and queries.device.type == "cpu":
        return align_reduce_reference(db, queries, R, S, n_songs)
    if db.device.type != "cuda" or queries.device != db.device:
        raise ValueError(
            "align_reduce: db on %s and queries on %s (both cuda, same card, "
            "or both cpu)" % (db.device, queries.device)
        )
    if db.dtype not in _DTYPES or queries.dtype != db.dtype:
        raise TypeError(
            "align_reduce kernel takes float32, bfloat16 or int8 db and "
            "queries of one dtype, got %s and %s" % (db.dtype, queries.dtype)
        )
    if db.dim() != 2 or queries.dim() != 3 or queries.shape[1:] != (S, db.shape[1]):
        raise ValueError(
            "align_reduce: db [N, d] and queries [B, S=%d, d] expected, got "
            "%s and %s" % (S, tuple(db.shape), tuple(queries.shape))
        )
    if not (db.is_contiguous() and queries.is_contiguous()):
        raise ValueError("align_reduce: db and queries must be contiguous")
    B, N, d = queries.shape[0], db.shape[0], db.shape[1]
    if R <= 0 or S <= 0 or n_songs < 0 or d % 4:
        raise ValueError("align_reduce kernel: R=%d S=%d n_songs=%d d=%d (d a "
                         "multiple of 4)" % (R, S, n_songs, d))
    if db.dtype == torch.int8 and S * d > INT8_MAX_SD:
        raise ValueError("align_reduce int8 kernel: S*d=%d must be <= %d (int32 "
                         "sums)" % (S * d, INT8_MAX_SD))
    ch = copy_bytes(d * db.element_size(), db.data_ptr(), queries.data_ptr())
    if ch == 0:
        raise ValueError("align_reduce kernel: db and queries must be 4-byte aligned "
                         "(a %s view starts off it)" % db.dtype)
    best = torch.empty(B, n_songs, dtype=torch.float32, device=db.device)
    argoff = torch.empty(B, n_songs, dtype=torch.int32, device=db.device)
    if B == 0 or n_songs == 0:
        return best, argoff
    item = db.element_size()
    if item != 4:  # TMA: 16-byte aligned bases and rows
        db, queries = _tma_aligned(db, queries)
    plan = tile_plan(B, S, d, item, R, n_songs)
    lib = _load()
    stream = torch.cuda.current_stream(db.device).cuda_stream
    with torch.cuda.device(db.device):
        if item == 4:
            rc = lib.align_reduce_f32_launch(
                db.data_ptr(), queries.data_ptr(), best.data_ptr(), argoff.data_ptr(), N, d,
                R, S, B, n_songs, plan["tn"], plan["tm"], plan["G"], plan["sc"], plan["abuf"],
                ch, plan["smem"], stream)
        else:
            entry = (lib.align_reduce_int8_launch if item == 1 else
                     lib.align_reduce_bf16_rowsum_launch if plan["rowsum"] else
                     lib.align_reduce_bf16_launch)
            rc = entry(
                db.data_ptr(), queries.data_ptr(), best.data_ptr(), argoff.data_ptr(), N,
                db.shape[1], R, S, B, n_songs, plan["tn"], plan["nwg"], plan["bps"], plan["mt"],
                int(plan["pp"]), plan["G"], plan["sc"], plan["abuf"], plan["qs"],
                int(plan["resident"]), plan["blocks"], plan["smem"], stream)
    if rc != 0:
        raise RuntimeError(
            "align_reduce kernel launch failed: %s (cudaError %d; d=%d S=%d "
            "B=%d n_songs=%d, %s, plan %s)"
            % (lib.align_reduce_error_string(rc).decode(), rc, d, S, B, n_songs,
               db.dtype, plan)
        )
    align_reduce.launches += 1
    align_reduce.launches_by_dtype[db.dtype] += 1
    return best, argoff


def reset_launch_counts() -> None:
    """Zero the kernel's launch counts (all dtypes, and per dtype)."""
    align_reduce.launches = 0
    align_reduce.launches_by_dtype = dict.fromkeys(_DTYPES, 0)


reset_launch_counts()

# Where PFANN_LAUNCH_LOG names a file, a process that launched the kernel
# appends its counts there as one JSON line when it exits: the evaluation
# harness's child processes report what they ran.
LAUNCH_LOG_ENV = "PFANN_LAUNCH_LOG"


def _log_launches() -> None:
    path = os.environ.get(LAUNCH_LOG_ENV)
    if path and align_reduce.launches:
        counts = {str(k).rsplit(".", 1)[-1]: v for k, v in align_reduce.launches_by_dtype.items()}
        with open(path, "a") as f:
            f.write(json.dumps({"argv": sys.argv, "launches": counts}) + "\n")


atexit.register(_log_launches)
