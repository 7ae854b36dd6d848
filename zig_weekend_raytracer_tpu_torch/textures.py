"""Texture evaluation the slice needs (counterpart of ``textures.py``):
solid colours come straight from the shade record; a checker picks one of
its two record colours by the 3D lattice parity of the hit point.  Image
textures and nested checkers belong to later slices (ROADMAP.md, slice 4)."""

from __future__ import annotations

import torch

from .math.v3 import V3


def checker_parity(inv_scale, point: V3) -> torch.Tensor:
    """3D lattice parity of the scaled hit point.  0 = even, 1 = odd."""
    xi = torch.floor(inv_scale * point.x).to(torch.int32)
    yi = torch.floor(inv_scale * point.y).to(torch.int32)
    zi = torch.floor(inv_scale * point.z).to(torch.int32)
    return torch.remainder(xi + yi + zi, 2)
