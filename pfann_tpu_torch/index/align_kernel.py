"""The align-reduce kernel: build, ctypes binding, wrapper, plain version.

``align_reduce`` is the port of the TPU kernel ``pallas_alignment_reduce``
(``pfann_tpu/index/pallas_align.py:84-129``), in f32, bf16 and int8 (int32
sums, ``pallas_align.py:49-52``).  On a CUDA tensor it launches the
hand-written kernel of ``csrc/align_reduce.cu`` (or raises); on a CPU
tensor it runs ``align_reduce_reference``, the plain PyTorch version
beside it.  There is no fallback from the kernel to the plain version.

bf16 and int8 run on the tensor cores, f32 on the CUDA cores (FFMA in
round-to-nearest f32, no TF32); all three are the same GEMM over layout
rows.  ``tile_plan`` works out each launch's tiles (query tile, row sums,
songs per block, window rows per stage, A stages, shared memory) here,
where a CPU test can check it, and the kernel checks the plan it is given.

The kernel is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface at first use, under ``pfann_tpu_torch/_build/``,
keyed by a hash of the source and the flags, and loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "align_reduce.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# the plain version chunks queries so its [N, S, chunk] score tensor (f32,
# or f64 for int8) stays under this many bytes
REFERENCE_SCORE_BYTES = 1 << 30
# an int8 row sum of S*d products (each at most 128^2) must fit the
# kernel's int32 accumulator
INT8_MAX_SD = (2**31 - 1) // (128 * 128)

# The kernel's tiles (csrc/align_reduce.cu, launch_mma for bf16 and int8,
# launch_f32 for f32).
SMEM_LIMIT = 232_448  # shared memory a block may use on sm_90 (227 KB)
SM_SMEM = 233_472  # shared memory of one SM (228 KB), 1 KB of it kept per block
SMS = 132  # streaming multiprocessors of an H100 SXM
# TN, queries per block.  Past 64, blocks of 64 queries with 256-row
# subtiles read half the query rows from L2 per output that 128 x 128
# tiles do: bf16 ran ~1.1x and int8 1.01-1.05x faster in them
# (tools/torch_kernel_sweep.py; PERF.md)
QUERY_TILES = (8, 16, 32, 64)
# bf16 and int8, TN -> (TM layout rows per M-subtile, threads per block)
TILE_CONFIGS = {8: (64, 128), 16: (128, 256), 32: (256, 256), 64: (256, 256)}
# f32, (TM, threads) at every TN: lanes of 8 rows x 8 queries (fewer
# queries below 64), so a K-step of 4 floats is 16 shared loads for 256
# FMAs.  128 queries a block (in 128-row subtiles) ran 3% slower than 64
# at the f32 serving shapes (tools/torch_kernel_sweep.py)
F32_TILE = (256, 256)
MAX_GROUP = 64  # songs per block
QUERY_STAGES = 2  # the kernel's ring of query-row stages (NST)
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
    library path.  A failed nvcc raises with its stderr."""
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
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            "nvcc failed (exit %d) building %s:\n%s"
            % (proc.returncode, SOURCE, proc.stderr)
        )
    os.replace(tmp, lib_path)
    build_info.update(path=lib_path, seconds=time.time() - tm, cached=False,
                      log=proc.stderr)
    return lib_path


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        lib.align_reduce_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, *[ctypes.c_int] * 13, ctypes.c_longlong,
            ctypes.c_void_p,
        ]
        lib.align_reduce_launch.restype = ctypes.c_int
        lib.align_reduce_error_string.argtypes = [ctypes.c_int]
        lib.align_reduce_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _song_group(R: int, tm: int, tn: int, n_songs: int, n_qtiles: int,
                resident: int = 0) -> int:
    """Songs per block: the fewest rows wasted rounding G*R up to a whole
    number of TM-row subtiles (ties to the larger G), with G*R at most 8
    subtiles, the per-song maxima under SEGMAX_BYTES, and at least two
    blocks per SM where the DB has that many songs.  With ``resident``
    (the blocks the card runs at once), the waste also counts the last,
    partly filled wave of blocks: f32 runs one block per SM, and at phase
    3's 1,000 songs 5 songs a block (25 waves of 3,200 blocks) ran 2-4%
    faster than 10 (13 waves of 1,600; tools/torch_kernel_sweep.py)."""
    hi = min(MAX_GROUP, SEGMAX_BYTES // (8 * tn), max(1, 8 * tm // R), n_songs,
             max(1, n_songs * n_qtiles // (2 * SMS)))

    def rows(g):
        return -(-g * R // tm) * tm / (g * R)

    def cost(g):  # rows, and the wave: costs within 1% count as equal
        blocks = -(-n_songs // g) * n_qtiles
        return round(rows(g) * -(-blocks // resident) * resident / blocks, 2)

    return min(range(1, max(1, hi) + 1),
               key=lambda g: (cost(g) if resident else 0, rows(g), -g))


def row_stride(d: int, itemsize: int) -> int:
    """Bytes between staged rows: the row rounded up to the K-step (32
    bytes for the MMAs, 16 for f32's float4 loads), plus 16."""
    step = 16 if itemsize == 4 else 32
    return -(-d * itemsize // step) * step + 16


def smem_bytes(d: int, itemsize: int, tm: int, tn: int, G: int, sc: int,
               abuf: int) -> int:
    """Dynamic shared memory of a plan (smem_bytes in the source): abuf A
    stages of tm + sc - 1 rows, QUERY_STAGES query-row stages of tn rows,
    and two 32-bit words per (song of the group, query)."""
    lds = row_stride(d, itemsize)
    return abuf * (tm + sc - 1) * lds + QUERY_STAGES * tn * lds + G * tn * 8


def tile_plan(B: int, S: int, d: int, itemsize: int, R: int, n_songs: int) -> dict:
    """The kernel's plan for f32 (itemsize 4), bf16 (2) or int8 (1):

    tn     queries per block: the smallest of QUERY_TILES that holds B
           (blocks of the largest past it);
    rowsum bf16 only, S*d > CHAIN_MAX_SD: each window row's MMAs sum apart
           and are added with round-to-nearest f32 adds (the tensor cores'
           f32 accumulation rounds toward zero, so one chain over
           S = 119 rows of d = 128 drifts 2.3e-3);
    tm     layout rows per M-subtile, and ``threads`` per block, of tn's
           kernel instantiation (TILE_CONFIGS; F32_TILE for f32);
    G      songs per block (``_song_group``; for f32 counting the last
           partial wave of its one block per SM);
    sc     window rows per A stage: S, unless S*d outgrows shared memory;
    abuf   A stages: 2 (the next subtile's rows load during this one's
           steps), or 1 where shared memory is short;
    smem   bytes of dynamic shared memory, at most SMEM_LIMIT;
    grid   (song groups, query tiles), which the kernel runs as a 1-D
           grid with the song group fastest.

    Query rows stream through a ring of QUERY_STAGES.  Two A stages are
    taken unless, for bf16 and int8, one A stage leaves room for two
    blocks per SM where two do not (on the H100 two blocks hide each
    other's barriers and loads; f32's registers hold it to one block per
    SM); then fewer window rows per stage, at one A stage; then a smaller
    query tile."""
    f32 = itemsize == 4
    lds = row_stride(d, itemsize)
    rowsum = itemsize == 2 and S * d > CHAIN_MAX_SD
    want = next(t for t in QUERY_TILES if t >= min(B, QUERY_TILES[-1]))
    for tn in sorted((t for t in QUERY_TILES if t <= want), reverse=True):
        tm, threads = F32_TILE if f32 else TILE_CONFIGS[tn]
        n_qtiles = -(-B // tn)
        G = _song_group(R, tm, tn, n_songs, n_qtiles, SMS if f32 else 0)

        def smem(sc, abuf):
            return smem_bytes(d, itemsize, tm, tn, G, sc, abuf)

        fit = [(S, a) for a in (2, 1) if smem(S, a) <= SMEM_LIMIT]
        if not f32:
            fit.sort(key=lambda t: -min(2, SM_SMEM // (smem(*t) + 1024)))  # stable
        if not fit:
            sc = (SMEM_LIMIT - QUERY_STAGES * tn * lds - G * tn * 8) // lds - tm + 1
            fit = [(min(sc, S), 1)] if sc >= 1 else []
        if fit:
            sc, abuf = fit[0]
            return dict(tn=tn, tm=tm, threads=threads, rowsum=rowsum, G=G, sc=sc,
                        abuf=abuf, smem=smem(sc, abuf), grid=(-(-n_songs // G), n_qtiles))
    raise ValueError("align_reduce: no tile plan fits %d bytes of shared memory "
                     "(d=%d, itemsize %d)" % (SMEM_LIMIT, d, itemsize))


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
    if db.dtype not in _DTYPE_CODES or queries.dtype != db.dtype:
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
    plan = tile_plan(B, S, d, db.element_size(), R, n_songs)
    lib = _load()
    with torch.cuda.device(db.device):
        rc = lib.align_reduce_launch(
            db.data_ptr(), queries.data_ptr(), best.data_ptr(),
            argoff.data_ptr(), N, d, R, S, B, n_songs, _DTYPE_CODES[db.dtype],
            plan["tn"], plan["tm"], int(plan["rowsum"]), plan["G"], plan["sc"],
            plan["abuf"], ch,
            plan["smem"], torch.cuda.current_stream().cuda_stream,
        )
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
    align_reduce.launches_by_dtype = dict.fromkeys(_DTYPE_CODES, 0)


reset_launch_counts()
