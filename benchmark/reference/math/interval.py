"""Batched interval arithmetic over torch tensors (counterpart of
``math/interval.py``).

The hot paths inline their own interval logic (strict ``surrounds`` in the
sphere test, inclusive ``contains`` in the quad test); this module is the
general API for scene construction and tests.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Interval(NamedTuple):
    min: torch.Tensor
    max: torch.Tensor

    def size(self):
        return self.max - self.min

    def union(self, other: "Interval") -> "Interval":
        return Interval(
            torch.minimum(self.min, other.min), torch.maximum(self.max, other.max)
        )

    def offset(self, displacement) -> "Interval":
        return Interval(self.min + displacement, self.max + displacement)

    def contains(self, x):
        """Inclusive membership."""
        return (x >= self.min) & (x <= self.max)

    def surrounds(self, x):
        """Strict membership."""
        return (x > self.min) & (x < self.max)

    def clamp(self, x):
        return torch.clamp(x, self.min, self.max)

    def expand(self, delta) -> "Interval":
        half = delta / 2
        return Interval(self.min - half, self.max + half)


INTERVAL_01 = Interval(torch.tensor(0.0), torch.tensor(1.0))
