"""The native CPU retrieval core (``native/seqscore.cpp``): build, ctypes
bindings, version handshake (port of ``pfann_tpu/index/native.py``).

The core is f32 host code independent of both packages' engines: brute
MIPS top-k plus the sequence rerank.  ``load`` binds the shared library
and ``matcher_binary`` the standalone matcher (``native/matcher.cpp`` with
the core), the binary ``cppmatcher`` drives.  Both are compiled with g++,
the flags of ``native/Makefile``, from the repository's sources into
``pfann_tpu_torch/_build/``, keyed by a hash of the sources and flags
(never into ``native/``); a failed build raises with the compiler's
stderr.  Where g++ cannot link OpenMP (no ``libgomp`` in the toolchain)
the core is built without ``-fopenmp``, with a warning: the same results,
on one thread.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

from pfann_tpu_torch.index.align_kernel import BUILD_DIR
from pfann_tpu_torch.utils.logging import get_logger

NATIVE_VERSION = 20260816001
NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
CXXFLAGS = ["-O3", "-std=c++17", "-fPIC", "-fopenmp", "-Wall"]
_LIB = None
_BUILD_LOCK = threading.Lock()  # threads of one process build once


def _build(name: str, sources: list[str], extra: list[str]) -> str:
    """Compile ``sources`` (in native/) into _build/<name>_<hash>, once per
    hash of the sources and flags; returns the output path."""
    with _BUILD_LOCK:
        return _build_locked(name, sources, extra)


def _build_locked(name: str, sources: list[str], extra: list[str]) -> str:
    paths = [os.path.join(NATIVE_DIR, s) for s in sources]
    text = b""
    for p in paths:
        with open(p, "rb") as f:
            text += f.read()
    for flags in (CXXFLAGS, [f for f in CXXFLAGS if f != "-fopenmp"]):
        key = hashlib.sha256(" ".join(flags + extra).encode() + text).hexdigest()[:16]
        out = os.path.join(BUILD_DIR, "%s_%s" % (name, key))
        if os.path.exists(out):
            return out
        cxx = shutil.which(os.environ.get("CXX", "g++"))
        if cxx is None:
            raise RuntimeError("g++ not found: the native core cannot be built")
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = "%s.%d.tmp" % (out, os.getpid())
        proc = subprocess.run([cxx, *flags, *extra, *paths, "-o", tmp],
                              capture_output=True, text=True)
        if proc.returncode == 0:
            os.replace(tmp, out)
            return out
        if flags is not CXXFLAGS or "libgomp" not in proc.stderr:
            raise RuntimeError("g++ failed (exit %d) building %s:\n%s"
                               % (proc.returncode, name, proc.stderr))
        why = next(ln for ln in proc.stderr.splitlines() if "libgomp" in ln)
        get_logger().warning("g++ cannot link OpenMP here (%s); building %s "
                             "without -fopenmp (one thread)", why.strip(), name)


def lib_path() -> str:
    """The shared library (built at first call)."""
    return _build("libpfannseq.so", ["seqscore.cpp"], ["-shared"])


def matcher_binary() -> str:
    """The standalone matcher binary (built at first call)."""
    return _build("matcher", ["matcher.cpp", "seqscore.cpp"], [])


def load():
    """Load (building if needed) the native core; refuses a library of
    another version (reference database.py:29-32)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.cdll.LoadLibrary(lib_path())
    lib.pfann_version.restype = ctypes.c_int64
    if lib.pfann_version() != NATIVE_VERSION:
        raise RuntimeError("native core version %d, expected %d"
                           % (lib.pfann_version(), NATIVE_VERSION))
    c_f32p = ctypes.POINTER(ctypes.c_float)
    c_i64p = ctypes.POINTER(ctypes.c_int64)
    lib.pfann_query.argtypes = [
        c_f32p, ctypes.c_int64, ctypes.c_int, c_i64p, ctypes.c_int,
        c_f32p, ctypes.c_int, ctypes.c_int, c_f32p, ctypes.c_int,
        ctypes.c_float,
    ]
    lib.pfann_query.restype = ctypes.c_int
    lib.pfann_seq_score.argtypes = [
        c_f32p, ctypes.c_int64, ctypes.c_int, c_i64p, ctypes.c_int,
        c_f32p, ctypes.c_int, c_i64p, ctypes.c_int, c_f32p, ctypes.c_int,
        ctypes.c_float,
    ]
    lib.pfann_seq_score.restype = ctypes.c_int
    lib.pfann_topk.argtypes = [
        c_f32p, ctypes.c_int64, ctypes.c_int, c_f32p, ctypes.c_int,
        ctypes.c_int, c_i64p, c_f32p,
    ]
    lib.pfann_topk.restype = None
    _LIB = lib
    return lib


def native_query(
    emb: np.ndarray,
    song_pos: np.ndarray,
    query: np.ndarray,
    top_k: int,
    frame_shift_mul: int = 1,
    score_alpha: float = 0.0,
) -> tuple[int, np.ndarray]:
    """Full native query; returns (best_song, song_scores [n_songs, 2]
    with times in sub-hop units)."""
    lib = load()
    emb = np.ascontiguousarray(emb, dtype=np.float32)
    song_pos = np.ascontiguousarray(song_pos, dtype=np.int64)
    query = np.ascontiguousarray(query, dtype=np.float32)
    if query.ndim != 2 or emb.ndim != 2 or query.shape[1] != emb.shape[1]:
        raise ValueError("native_query: emb [N, d] and query [S, d] expected, got "
                         "%s and %s" % (emb.shape, query.shape))
    if song_pos[-1] != emb.shape[0]:
        raise ValueError("native_query: song_pos ends at %d, emb has %d rows"
                         % (song_pos[-1], emb.shape[0]))
    n_songs = len(song_pos) - 1
    song_scores = np.zeros((n_songs, 2), dtype=np.float32)
    f32p = ctypes.POINTER(ctypes.c_float)
    i64p = ctypes.POINTER(ctypes.c_int64)
    best = lib.pfann_query(
        emb.ctypes.data_as(f32p), emb.shape[0], emb.shape[1],
        song_pos.ctypes.data_as(i64p), n_songs,
        query.ctypes.data_as(f32p), query.shape[0],
        top_k, song_scores.ctypes.data_as(f32p),
        frame_shift_mul, score_alpha,
    )
    return best, song_scores
