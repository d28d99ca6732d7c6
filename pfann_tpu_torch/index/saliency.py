"""Gradient-saliency images for matcher queries (port of
``pfann_tpu/index/saliency.py``).

``saliency_image`` is a copy of the JAX package's (reference
matcher.py:118-125,133-155): red is the inf-normalized |gradient| of the
embedding against itself at the mel input, green the log-mel energy
dimmed where saliency is high.  The PNG is written with ``zlib`` and
``struct`` (8-bit RGB, one IDAT chunk, filter 0), so no imaging library
is needed; the file name and directory are the JAX package's.
"""

from __future__ import annotations

import math
import os
import struct
import zlib

import numpy as np


def saliency_image(grads: np.ndarray, specs: np.ndarray) -> np.ndarray:
    """grads/specs: [S, F, T] (per-segment mel gradients and mel values).

    Returns an RGB uint8 image [F, S*T, 3]: R = |grad| inf-normalized per
    (segment, frame) column, G = mel energy scaled to [0, 1] and dimmed
    by (1 - R), B = 0; frequency axis flipped so low frequencies sit at
    the bottom; a black column marks each segment boundary.
    """
    sal = np.abs(np.asarray(grads, dtype=np.float32))
    denom = np.maximum(sal.max(axis=1, keepdims=True), 1e-12)
    sal = sal / denom  # inf-norm over the frequency axis

    def tile(x):  # [S, F, T] -> [F, S*T]
        return np.transpose(x, (1, 0, 2)).reshape(x.shape[1], -1)

    red = tile(sal)
    energy = tile(np.asarray(specs, dtype=np.float32)) - math.log(1e-6)
    energy = energy / max(float(energy.max()), 1e-12)
    green = energy * (1.0 - red)
    img = np.stack([red, green, np.zeros_like(red)], axis=-1)
    img = img[::-1]  # low frequencies at the bottom
    img[:, :: grads.shape[2]] = 0  # segment-boundary markers
    return (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def png_bytes(img: np.ndarray) -> bytes:
    """An 8-bit RGB image [H, W, 3] uint8 as PNG bytes: IHDR, one IDAT of
    the zlib-compressed rows (each led by filter byte 0), IEND."""
    h, w, c = img.shape
    if c != 3 or img.dtype != np.uint8:
        raise ValueError("png_bytes: uint8 [H, W, 3] expected, got %s %s"
                         % (img.dtype, img.shape))
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + _chunk(b"IEND", b""))


def save_saliency_png(
    out_dir: str, query_name: str, grads: np.ndarray, specs: np.ndarray
) -> str:
    path = os.path.join(out_dir, os.path.basename(query_name) + ".png")
    with open(path, "wb") as f:
        f.write(png_bytes(saliency_image(grads, specs)))
    return path
