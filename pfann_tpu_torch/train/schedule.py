"""Learning-rate schedule (a copy of ``pfann_tpu/train/schedule.py``).

PyTorch's CosineAnnealingWarmRestarts, stepped once per epoch, with T_0 =
total epochs and eta_min = 1e-7 (reference train.py:25-39,60-61).  With
T_0 = total epochs there is no restart inside a run; the t_mult branch is
kept for config parity.
"""

from __future__ import annotations

import math


def cosine_warm_restarts(
    base_lr: float,
    t0: int,
    t_mult: int = 1,
    eta_min: float = 1e-7,
):
    """Returns lr(epoch) implementing SGDR (Loshchilov & Hutter 2016)
    restart arithmetic, matching torch semantics for integer epochs."""

    def lr(epoch: int) -> float:
        t_cur = epoch
        t_i = t0
        if t_mult == 1:
            t_cur = t_cur % t0
        else:
            while t_cur >= t_i:
                t_cur -= t_i
                t_i *= t_mult
        return eta_min + (base_lr - eta_min) * (1 + math.cos(math.pi * t_cur / t_i)) / 2

    return lr
