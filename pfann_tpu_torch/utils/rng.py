"""Explicit random streams for training: one CPU ``torch.Generator`` per
(purpose, epoch, step) key, never global RNG state."""

from __future__ import annotations

import numpy as np
import torch


def seeded_generator(*key: int) -> torch.Generator:
    """A CPU generator seeded from a hash of the non-negative ints ``key``
    (numpy's ``SeedSequence``), so a stream depends on where it is drawn,
    not on what was drawn before: a resumed run repeats an uninterrupted
    one."""
    seed = np.random.SeedSequence([int(k) for k in key]).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(seed))
