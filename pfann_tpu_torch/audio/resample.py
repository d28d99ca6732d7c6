"""Sample-rate conversion (host side).

A copy of ``pfann_tpu/audio/resample.py``, so that the port imports
nothing of the JAX package.

Replaces the reference's torch resamplers (torchaudio Resample in
preprocess.py:24, julius.ResampleFrac in musicdata.py:29) with a
polyphase FIR resampler.  scipy.signal.resample_poly does the heavy
lifting in C with a Kaiser-windowed sinc — the same family of filters
julius/torchaudio use; embedding-level behavior is equivalent since the
model is trained with this front end.
"""

from __future__ import annotations

import math

import numpy as np
from scipy.signal import resample_poly


def resample(x: np.ndarray, orig_sr: int, new_sr: int) -> np.ndarray:
    """Resample along the last axis. x: float array [..., N]."""
    if orig_sr == new_sr:
        return np.asarray(x, dtype=np.float32)
    g = math.gcd(int(orig_sr), int(new_sr))
    up, down = new_sr // g, orig_sr // g
    return resample_poly(np.asarray(x, dtype=np.float32), up, down, axis=-1).astype(
        np.float32
    )
