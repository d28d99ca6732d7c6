"""FpNetwork's whole-volume LayerNorm and its activation as one kernel.

``norm_act`` writes act(LayerNorm(x)) over a conv's output x [N, C, F, T]
(LayerNorm(act(x)) where the activation comes first): per segment, the
mean and variance of the whole (C, F, T) volume in float32, the affine in
float32, the result rounded to x's dtype, then the activation in that
dtype.  These are the arithmetic and rounding points of ``FullLayerNorm``
and the activation as ``SeparableConv`` runs them with autograd.

On a CUDA tensor it launches the hand-written kernel of
``csrc/norm_act.cu`` (or raises); on a CPU tensor it runs
``norm_act_reference``, the plain PyTorch version beside it.  There is no
fallback from the kernel to the plain version.  The kernel moves whole
16-byte vectors: a segment's volume is a multiple of 16 bytes' elements
and the tensors are 16-byte aligned, or ``norm_act`` raises.  It replaces
no TPU kernel (the JAX package leaves the norm to XLA); it is bound by
bytes, and reads each element of x once and writes it once (the source
says how).  ``plan`` picks its form and tiles from the volume alone, here
where a CPU test can check it.  ``launches`` counts the kernel's calls on
the card, one a norm over a batch whatever its form launches.

The kernel is compiled with ``nvcc`` for ``sm_90a`` into a shared library
at first use, under ``pfann_tpu_torch/_build/``, keyed by a hash of the
source and the flags, and loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time

import torch
import torch.nn.functional as F

from pfann_tpu_torch.index import align_kernel

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "norm_act.cu")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
ACTIVATIONS = {"ReLU": F.relu, "ELU": F.elu}
_ACT_CODES = {"ReLU": 0, "ELU": 1}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# The kernel's tiles (csrc/norm_act.cu): THREADS a block.  The rows form
# stages a segment of at most ROWS_MAX 16-byte vectors in one block's
# shared memory, VPT vectors a thread of S segments a group of G threads;
# ROWS_TILES lists the (VPT, S) the source builds (NA_ROWS_TILES there),
# 64 KB of staging a block each, the fewest vectors a thread first.  Larger
# segments take the split form, a stats pass and an apply pass over 16
# segments a block (SPB there).
THREADS = 512
ROWS_TILES = ((2, 4), (4, 2), (8, 1))
ROWS_MAX = THREADS * 8
STATS_VPT = 4  # the split form's stats chunk: THREADS * STATS_VPT vectors

_lib = None
build_info: dict = {}
launches = 0


def build() -> str:
    """Compile csrc/norm_act.cu (once per source hash); returns the library
    path.  A failed nvcc raises with its stderr."""
    with open(SOURCE, "rb") as f:
        src = f.read()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = os.path.join(align_kernel.BUILD_DIR, "libnorm_act_%s.so" % key)
    if os.path.exists(lib_path):
        build_info.update(path=lib_path, seconds=0.0, cached=True)
        return lib_path
    os.makedirs(align_kernel.BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.tmp" % (lib_path, os.getpid())
    tm = time.time()
    proc = subprocess.run([align_kernel._nvcc(), *NVCC_FLAGS, "-shared", "-o", tmp, SOURCE],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed (exit %d) building %s:\n%s"
                           % (proc.returncode, SOURCE, proc.stderr))
    os.replace(tmp, lib_path)
    build_info.update(path=lib_path, seconds=time.time() - tm, cached=False, log=proc.stderr)
    return lib_path


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.norm_act_rows_launch.argtypes = [
            i32, i32, i32, ptr, ptr, ptr, ptr, ptr, i64, i64, i32, ctypes.c_float, i32, i32, ptr]
        lib.norm_act_split_launch.argtypes = [
            i32, ptr, ptr, ptr, ptr, ptr, ptr, i64, i64, ctypes.c_float, i32, i32, ptr]
        for fn in (lib.norm_act_rows_launch, lib.norm_act_split_launch):
            fn.restype = ctypes.c_int
        lib.norm_act_error_string.argtypes = [ctypes.c_int]
        lib.norm_act_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def plan(V: int, itemsize: int) -> dict:
    """The kernel's form and tiles for segments of V elements of
    ``itemsize`` bytes (4: float32, 2: bfloat16), V a multiple of a
    16-byte vector's elements (else ValueError):

    "rows" up to ROWS_MAX vectors a segment: a group of G threads (a power
    of two, 32 to THREADS) holds segs segments, vpt vectors a thread of
    each, the first tile of ROWS_TILES whose block holds the segment; one
    read and one write an element.  "split" past it: a stats pass, then an
    apply pass over 16 segments a block; two reads and one write an
    element.  At the d=128 encoder's volumes the rows form measured faster
    up to 32,768 bf16 elements and the split form past it, where a segment
    no longer fits one block (PERF.md)."""
    vec = 16 // itemsize
    if V < 1 or V % vec:
        raise ValueError("norm_act: a segment of %d elements of %d bytes is not whole 16-byte "
                         "vectors" % (V, itemsize))
    nv = V // vec
    if nv > ROWS_MAX:
        return dict(form="split")
    vpt, segs = next((v, s) for v, s in ROWS_TILES if nv <= THREADS * v)
    return dict(form="rows", vpt=vpt, G=max(32, _pow2(-(-nv // vpt))), segs=segs)


def norm_act_reference(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
    activation: str, relu_after_bn: bool,
) -> torch.Tensor:
    """Plain PyTorch version: ``F.layer_norm`` of x's float32 copy over
    x.shape[1:], cast back to x's dtype, then the activation in that dtype
    (before the norm where ``relu_after_bn`` is false).  Returns a new
    tensor."""
    act = ACTIVATIONS[activation]

    def ln(a):
        shape = a.shape[1:]
        return F.layer_norm(a.float(), shape, weight.reshape(shape), bias.reshape(shape),
                            eps).to(a.dtype)

    return act(ln(x)) if relu_after_bn else ln(act(x))


def _launch(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
            activation: str, relu_after_bn: bool, p: dict,
            stats: torch.Tensor | None = None) -> None:
    """Launch plan ``p`` on checked tensors, writing over x, and count it
    in ``launches``; ``stats`` (f32 [N, 2], optional) receives each
    segment's mean and rstd."""
    global launches
    N, V = x.shape[0], x[0].numel()
    lib = _load()
    dt = _DTYPES[x.dtype]
    act, act_first = _ACT_CODES[activation], int(not relu_after_bn)
    st = stats.data_ptr() if stats is not None else None
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        if p["form"] == "rows":
            rc = lib.norm_act_rows_launch(
                dt, p["vpt"], p["segs"], x.data_ptr(), x.data_ptr(), weight.data_ptr(),
                bias.data_ptr(), st, N, V, p["G"], eps, act, act_first, stream)
        else:
            K = -(-(V * x.element_size() // 16) // (THREADS * STATS_VPT))
            part = torch.empty(N * K * 2, dtype=torch.float32, device=x.device)
            rc = lib.norm_act_split_launch(
                dt, x.data_ptr(), x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                part.data_ptr(), st, N, V, eps, act, act_first, stream)
    if rc != 0:
        raise RuntimeError("norm_act kernel launch failed: %s (cudaError %d; N=%d V=%d, %s, "
                           "plan %s)" % (lib.norm_act_error_string(rc).decode(), rc, N, V,
                                         x.dtype, p))
    launches += 1


def norm_act(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
    activation: str, relu_after_bn: bool,
) -> torch.Tensor:
    """x [N, ...] (float32 or bfloat16, contiguous), weight and bias
    float32 of x[0]'s numel.  Writes the norm and activation (see the
    module) over x and returns it: callers pass a tensor nothing else
    reads, such as a conv's output.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    whose segments are whole 16-byte vectors, 16-byte aligned."""
    if activation not in ACTIVATIONS:
        raise KeyError(activation)
    if x.device.type == "cpu":
        return x.copy_(norm_act_reference(x, weight, bias, eps, activation, relu_after_bn))
    if x.device.type != "cuda" or weight.device != x.device or bias.device != x.device:
        raise ValueError("norm_act: x on %s, weight on %s, bias on %s (one card, or cpu)"
                         % (x.device, weight.device, bias.device))
    if x.dtype not in _DTYPES or weight.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError("norm_act kernel takes float32 or bfloat16 x and float32 weight and "
                        "bias, got %s, %s, %s" % (x.dtype, weight.dtype, bias.dtype))
    if x.dim() < 2 or weight.numel() != x[0].numel() or bias.numel() != x[0].numel():
        raise ValueError("norm_act: x [N, ...] and an affine of x[0]'s size expected, got %s, "
                         "%s, %s" % (tuple(x.shape), tuple(weight.shape), tuple(bias.shape)))
    if not (x.is_contiguous() and weight.is_contiguous() and bias.is_contiguous()):
        raise ValueError("norm_act: x, weight and bias must be contiguous")
    if x.shape[0] == 0 or x[0].numel() == 0:
        return x
    if any(t.data_ptr() % 16 for t in (x, weight, bias)):
        raise ValueError("norm_act: x, weight and bias must be 16-byte aligned")
    _launch(x, weight, bias, eps, activation, relu_after_bn,
            plan(x[0].numel(), x.element_size()))
    return x
