"""Exact int16 staging of decoded audio for the host-to-device copy.

A copy of ``int16_if_exact`` from ``pfann_tpu/utils/fastcast.py``, so that
the port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np


def int16_if_exact(wav: np.ndarray) -> np.ndarray:
    """int16 view of a decoded audio signal when that is EXACT (every
    value is k/32768 with |k| <= 32767 — true for un-resampled 16-bit
    WAV), else the float32 signal unchanged.  int16 halves the bytes the
    host-to-device copy moves and the on-device rescale by 1/32768 is a
    power-of-2 divide, so downstream f32 math is bit-identical."""
    w = np.asarray(wav, np.float32).reshape(-1)
    s = w * 32768.0
    if np.all(np.abs(s) <= 32767.0) and np.all(s == np.trunc(s)):
        return s.astype(np.int16)
    return w
