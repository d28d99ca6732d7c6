"""``model.msgpack`` without flax or msgpack: reader, writer, weight bridge.

Every DB directory holds the model as ``flax.serialization.to_bytes`` of
the variables tree (``pfann_tpu/utils/checkpoint.py:62-76``).  That is the
msgpack encoding of a nested ``{str: subtree | ndarray}`` map in which
each array is an ext object of type 1 whose payload is itself
``msgpack.packb((shape, dtype_name, raw_bytes))``.  This module decodes
and encodes exactly that subset in pure Python, so the port reads and
writes the file on a machine that has neither package.  Leaves come back
as CPU tensors; ``bfloat16`` is read straight into ``torch.bfloat16``.

The weight bridge maps the flax parameter tree of
``pfann_tpu.models.fp_network.FpNetwork`` onto the state dict of
``pfann_tpu_torch.models.fp_network.FpNetwork`` and back:

    f/block{i}/conv{1,2}/kernel  (kh, kw, I, O)  <->  f.block{i}.conv{1,2}.weight  (O, I, kh, kw)
    f/block{i}/conv{1,2}/bias    (O,)            <->  ...bias
    f/block{i}/ln{1,2}/scale     (F, T, C)       <->  f.block{i}.ln{1,2}.weight    (C, F, T)
    f/block{i}/ln{1,2}/bias      (F, T, C)       <->  ...bias                      (C, F, T)
    g/{w1,b1,w2,b2}                              <->  g.{w1,b1,w2,b2} (einsum weights, same shape)

A depthwise ``conv2`` (``fuller`` false) has I = 1 in both layouts.
"""

from __future__ import annotations

import os
import struct
from typing import Any

import numpy as np
import torch

MODEL_FILE_NAME = "model.msgpack"

_EXT_NDARRAY = 1
# flax splits leaves above this many bytes into chunk maps, which this
# module does not read or write (FpNetwork's largest leaf is ~12 MB)
_MAX_CHUNK_SIZE = 2**30

_DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "bool": torch.bool,
}
_DTYPE_NAMES = {v: k for k, v in _DTYPES.items()}


# ------------------------------------------------------------------ decode
class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        out = self.data[self.pos : self.pos + n]
        if len(out) != n:
            raise ValueError("truncated msgpack data")
        self.pos += n
        return out

    def unpack(self, fmt: str):
        (v,) = struct.unpack(fmt, self.take(struct.calcsize(fmt)))
        return v

    def obj(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.obj() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return bytes(self.take(b & 0x1F)).decode("utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b in lengths:
            return bytes(self.take(self.unpack(lengths[b])))
        ext_lengths = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in ext_lengths:
            n = self.unpack(ext_lengths[b])
            return self._ext(self.unpack(">b"), n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self._ext(self.unpack(">b"), fixext[b])
        numbers = {
            0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
            0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
        }
        if b in numbers:
            return self.unpack(numbers[b])
        strs = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in strs:
            return bytes(self.take(self.unpack(strs[b]))).decode("utf-8")
        if b in (0xDC, 0xDD):
            n = self.unpack(">H" if b == 0xDC else ">I")
            return [self.obj() for _ in range(n)]
        if b in (0xDE, 0xDF):
            return self._map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError("unsupported msgpack type byte 0x%02x" % b)

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def _ext(self, code: int, n: int):
        payload = bytes(self.take(n))
        if code != _EXT_NDARRAY:
            raise ValueError("unsupported msgpack ext type %d" % code)
        shape, name, raw = _Reader(payload).obj()
        if isinstance(name, bytes):
            name = name.decode("ascii")
        return _tensor_from_bytes(tuple(shape), name, raw)


def _tensor_from_bytes(shape: tuple, name: str, raw: bytes) -> torch.Tensor:
    if name not in _DTYPES:
        raise ValueError("unsupported array dtype %r in checkpoint" % name)
    dtype = _DTYPES[name]
    if not raw:
        return torch.empty(shape, dtype=dtype)
    return torch.frombuffer(bytearray(raw), dtype=dtype).reshape(shape)


def msgpack_restore(data: bytes) -> dict:
    """Decode ``flax.serialization.to_bytes`` output into a nested dict of
    CPU tensors (the counterpart of ``flax.serialization.msgpack_restore``)."""
    r = _Reader(data)
    tree = r.obj()
    if r.pos != len(data):
        raise ValueError("trailing bytes after the msgpack object")
    return tree


# ------------------------------------------------------------------ encode
def _pack_len(out: bytearray, n: int, small: tuple, codes: tuple):
    """Length header: a fixed-size form when ``small`` allows it, else the
    8/16/32-bit forms named by ``codes`` (None where the type has none)."""
    fix_base, fix_max = small
    if fix_base is not None and n <= fix_max:
        out.append(fix_base | n)
    elif codes[0] is not None and n <= 0xFF:
        out += bytes([codes[0], n])
    elif n <= 0xFFFF:
        out.append(codes[1])
        out += struct.pack(">H", n)
    else:
        out.append(codes[2])
        out += struct.pack(">I", n)


def _pack(out: bytearray, x) -> None:
    if isinstance(x, dict):
        _pack_len(out, len(x), (0x80, 15), (None, 0xDE, 0xDF))
        for k, v in x.items():
            if not isinstance(k, str):
                raise TypeError("checkpoint keys must be str, got %r" % (k,))
            _pack(out, k)
            _pack(out, v)
    elif isinstance(x, str):
        b = x.encode("utf-8")
        _pack_len(out, len(b), (0xA0, 31), (0xD9, 0xDA, 0xDB))
        out += b
    elif isinstance(x, bytes):
        _pack_len(out, len(x), (None, -1), (0xC4, 0xC5, 0xC6))
        out += x
    elif isinstance(x, (list, tuple)):
        _pack_len(out, len(x), (0x90, 15), (None, 0xDC, 0xDD))
        for v in x:
            _pack(out, v)
    elif isinstance(x, int) and not isinstance(x, bool):
        if x < 0:
            raise ValueError("negative ints do not occur in checkpoints")
        if x <= 0x7F:
            out.append(x)
        else:
            for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                                   (0xCE, ">I", 0xFFFFFFFF),
                                   (0xCF, ">Q", 2**64 - 1)):
                if x <= top:
                    out.append(code)
                    out += struct.pack(fmt, x)
                    break
    elif isinstance(x, (torch.Tensor, np.ndarray)):
        _pack_ext(out, _EXT_NDARRAY, _array_payload(x))
    else:
        raise TypeError("cannot serialize %s" % type(x).__name__)


def _array_payload(x) -> bytes:
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu").contiguous()
        if t.dtype not in _DTYPE_NAMES:
            raise TypeError("unsupported tensor dtype %s" % t.dtype)
        name = _DTYPE_NAMES[t.dtype]
        raw = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()
        shape = tuple(t.shape)
    else:
        name, raw, shape = x.dtype.name, x.tobytes("C"), x.shape
    if len(raw) > _MAX_CHUNK_SIZE:
        raise ValueError("leaf of %d bytes exceeds one msgpack chunk" % len(raw))
    out = bytearray()
    _pack(out, (tuple(int(s) for s in shape), name, raw))
    return bytes(out)


def _pack_ext(out: bytearray, code: int, payload: bytes) -> None:
    n = len(payload)
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixext:
        out.append(fixext[n])
    else:
        _pack_len(out, n, (None, -1), (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code)
    out += payload


def msgpack_serialize(tree: dict) -> bytes:
    """Encode a nested ``{str: subtree | tensor | ndarray}`` map the way
    ``flax.serialization.to_bytes`` does."""
    out = bytearray()
    _pack(out, tree)
    return bytes(out)


# ------------------------------------------------------------ weight bridge
def params_from_flax(tree: dict[str, Any]) -> dict[str, torch.Tensor]:
    """Flax FpNetwork params (with or without the ``params`` collection
    level) -> the port's FpNetwork state dict."""
    if "params" in tree:
        tree = tree["params"]
    sd: dict[str, torch.Tensor] = {}
    for bname, block in tree["f"].items():
        for lname, layer in block.items():
            p = "f.%s.%s." % (bname, lname)
            if lname.startswith("conv"):
                sd[p + "weight"] = layer["kernel"].permute(3, 2, 0, 1).contiguous()
                sd[p + "bias"] = layer["bias"]
            else:
                sd[p + "weight"] = layer["scale"].permute(2, 0, 1).contiguous()
                sd[p + "bias"] = layer["bias"].permute(2, 0, 1).contiguous()
    for k, v in tree["g"].items():
        sd["g." + k] = v
    return sd


def params_to_flax(state_dict: dict[str, torch.Tensor]) -> dict[str, Any]:
    """Inverse of :func:`params_from_flax`: returns the flax ``params``
    tree (without the collection level)."""
    f: dict[str, dict] = {}
    g: dict[str, torch.Tensor] = {}
    for key, v in state_dict.items():
        v = v.detach().to("cpu")
        parts = key.split(".")
        if parts[0] == "g":
            g[parts[1]] = v.contiguous()
            continue
        _, bname, lname, pname = parts
        layer = f.setdefault(bname, {}).setdefault(lname, {})
        if lname.startswith("conv"):
            if pname == "weight":
                layer["kernel"] = v.permute(2, 3, 1, 0).contiguous()
            else:
                layer["bias"] = v.contiguous()
        else:
            layer["scale" if pname == "weight" else "bias"] = (
                v.permute(1, 2, 0).contiguous()
            )
    return {"f": f, "g": g}


def _model_path(path_or_dir: str) -> str:
    if os.path.isdir(path_or_dir):
        return os.path.join(path_or_dir, MODEL_FILE_NAME)
    return path_or_dir


def load_model(path_or_dir: str) -> dict[str, torch.Tensor]:
    """Read ``model.msgpack`` into the port's FpNetwork state dict."""
    with open(_model_path(path_or_dir), "rb") as f:
        return params_from_flax(msgpack_restore(f.read()))


def save_model(path_or_dir: str, state_dict: dict[str, torch.Tensor]) -> str:
    """Write the port's FpNetwork state dict as ``model.msgpack`` in the
    layout ``pfann_tpu.utils.checkpoint.load_model`` reads."""
    path = _model_path(path_or_dir)
    with open(path, "wb") as f:
        f.write(msgpack_serialize({"params": params_to_flax(state_dict)}))
    return path
