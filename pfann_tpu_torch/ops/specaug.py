"""SpecAugment-style cutout masking (port of ``pfann_tpu/ops/specaug.py``).

One [F, T] mask for the whole batch (reference datautil/specaug.py:3-42):
a cutout box, a full-height frequency stripe and a full-width time stripe.
Each extent is ``floor(size * U[cutout_min, cutout_max])``, each start
uniform in ``[0, size - extent]`` inclusive.

Drawing and applying are apart: :meth:`SpecAugment.draw` takes the eight
scalars from a CPU ``torch.Generator`` (so a train step makes no
device-to-host sync), :meth:`SpecAugment.get_mask` builds the mask from
them on any device.  Tests feed the mask builder JAX's own draws.
"""

from __future__ import annotations

from typing import Any

import torch

# (start, extent) of the box's F and T sides, the F stripe, the T stripe
Draws = tuple[tuple[int, int], tuple[int, int], tuple[int, int], tuple[int, int]]


class SpecAugment:
    def __init__(self, params: dict[str, Any]):
        self.cutout_min = params.get("cutout_min", 0.1)
        self.cutout_max = params.get("cutout_max", 0.5)

    def draw(self, generator: torch.Generator, F: int, T: int) -> Draws:
        """The eight scalars of one mask, in JAX's order (box F, box T,
        F stripe, T stripe), each side as (start, extent)."""
        lo, hi = self.cutout_min, self.cutout_max

        def side(size: int) -> tuple[int, int]:
            frac = lo + torch.rand((), generator=generator).item() * (hi - lo)
            ext = int(size * frac)
            start = int(torch.randint(0, size - ext + 1, (), generator=generator))
            return start, ext

        return side(F), side(T), side(F), side(T)

    @staticmethod
    def get_mask(draws: Draws, F: int, T: int, device=None) -> torch.Tensor:
        """{0, 1} float32 mask [F, T]; 1 = erase."""
        (f0, fe), (t0, te), (f1, fe1), (t1, te1) = draws
        mask = torch.zeros(F, T, device=device)
        mask[f0 : f0 + fe, t0 : t0 + te] = 1.0
        mask[f1 : f1 + fe1, :] = 1.0
        mask[:, t1 : t1 + te1] = 1.0
        return mask

    def augment(self, draws: Draws, x: torch.Tensor) -> torch.Tensor:
        """x: [..., F, T]; one shared mask for the whole batch."""
        mask = self.get_mask(draws, x.shape[-2], x.shape[-1], device=x.device)
        return x * (1.0 - mask)
