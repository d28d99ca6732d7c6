"""The align-reduce kernel: build, ctypes binding, wrapper, plain version.

``align_reduce`` is the port of the TPU kernel ``pallas_alignment_reduce``
(``pfann_tpu/index/pallas_align.py:84-129``), in f32, bf16 and int8 (int32
sums, ``pallas_align.py:49-52``).  On a CUDA tensor it launches the
hand-written kernel of ``csrc/align_reduce.cu`` (or raises); on a CPU
tensor it runs ``align_reduce_reference``, the plain PyTorch version
beside it.  There is no fallback from the kernel to the plain version.

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
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.align_reduce_launch.restype = ctypes.c_int
        lib.align_reduce_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.align_reduce_smem_bytes.restype = ctypes.c_longlong
        lib.align_reduce_error_string.argtypes = [ctypes.c_int]
        lib.align_reduce_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


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
    window=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: matmul to [N, S, B] (chunked
    over B), the diagonal sum over window rows, then the per-song max and
    last-index argmax.  Same contract as :func:`align_reduce`.  Float
    inputs compute in f32; int8 inputs in f64, where every product and sum
    of int8 values is an exact integer (an f32 sum stops being exact past
    2^24), so best and argoff equal the kernel's int32 ones bit for bit.

    ``window(i, ip, batch)`` (optional) maps window row i's inner products
    ip [n_songs*R, n], for the queries ``batch`` (a slice of B), to what
    that row adds to the sum; the kernel has no such hook."""
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
    if db.dtype == torch.int8 and (
            S * d > INT8_MAX_SD or db.data_ptr() % 4 or queries.data_ptr() % 4):
        raise ValueError("align_reduce int8 kernel: S*d=%d must be <= %d (int32 "
                         "sums) and db and queries 4-byte aligned"
                         % (S * d, INT8_MAX_SD))
    best = torch.empty(B, n_songs, dtype=torch.float32, device=db.device)
    argoff = torch.empty(B, n_songs, dtype=torch.int32, device=db.device)
    if B == 0 or n_songs == 0:
        return best, argoff
    lib = _load()
    with torch.cuda.device(db.device):
        rc = lib.align_reduce_launch(
            db.data_ptr(), queries.data_ptr(), best.data_ptr(),
            argoff.data_ptr(), N, d, R, S, B, n_songs, _DTYPE_CODES[db.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            "align_reduce kernel launch failed: %s (cudaError %d; d=%d S=%d "
            "needs %d bytes of shared memory, B=%d, n_songs=%d)"
            % (lib.align_reduce_error_string(rc).decode(), rc, d, S,
               lib.align_reduce_smem_bytes(d, S, _DTYPE_CODES[db.dtype]), B,
               n_songs)
        )
    align_reduce.launches += 1
    align_reduce.launches_by_dtype[db.dtype] += 1
    return best, argoff


def reset_launch_counts() -> None:
    """Zero the kernel's launch counts (all dtypes, and per dtype)."""
    align_reduce.launches = 0
    align_reduce.launches_by_dtype = dict.fromkeys(_DTYPE_CODES, 0)


reset_launch_counts()
