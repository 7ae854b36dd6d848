"""Texture evaluation (counterpart of ``textures.py``): solid colours come
straight from the shade record; a checker picks one of its two record
colours by the 3D lattice parity of the hit point; an image is a
nearest-texel fetch from the scene's packed atlas, byte -> linear by the
gamma-2 square.  The texture LUT (``lut_*``) and the general walk of
nested checkers belong to a later slice (ROADMAP.md)."""

from __future__ import annotations

import torch

from .dtypes import real
from .math.v3 import V3

_INV_255 = float(torch.tensor(1.0 / 255.0, dtype=real))


def checker_parity(inv_scale, point: V3) -> torch.Tensor:
    """3D lattice parity of the scaled hit point.  0 = even, 1 = odd."""
    xi = torch.floor(inv_scale * point.x).to(torch.int32)
    yi = torch.floor(inv_scale * point.y).to(torch.int32)
    zi = torch.floor(inv_scale * point.z).to(torch.int32)
    return torch.remainder(xi + yi + zi, 2)


def atlas_flat_index(image_dims, atlas_hw, img_id, u, v) -> torch.Tensor:
    """(u, v, image) -> flat index into the packed atlas plane from the
    static per-image (width, height): u and v clamped to [0, 1], v flipped
    to image rows, the texel coordinate truncated and clamped to the
    image."""
    ah, aw = atlas_hw
    w = torch.zeros_like(u)
    h = torch.zeros_like(u)
    wi = torch.zeros_like(img_id)
    hi = torch.zeros_like(img_id)
    for i, (iw, ih) in enumerate(image_dims):
        sel = img_id == i
        w = torch.where(sel, float(iw), w)
        h = torch.where(sel, float(ih), h)
        wi = torch.where(sel, iw, wi)
        hi = torch.where(sel, ih, hi)
    uc = torch.clamp(u, 0.0, 1.0)
    vc = 1.0 - torch.clamp(v, 0.0, 1.0)  # flip to image rows
    x = torch.minimum(torch.clamp((uc * w).to(torch.int32), min=0), wi - 1)
    y = torch.minimum(torch.clamp((vc * h).to(torch.int32), min=0), hi - 1)
    return img_id * (ah * aw) + y * aw + x


def _unpack_texel(packed) -> V3:
    texel = V3(
        (packed & 0xFF).to(real) * _INV_255,
        ((packed >> 8) & 0xFF).to(real) * _INV_255,
        ((packed >> 16) & 0xFF).to(real) * _INV_255,
    )
    return texel * texel  # gamma-2 linearize


def atlas_lookup_flat(scene, flat) -> V3:
    """Packed-atlas fetch by flat texel index: one gather of the
    r | g << 8 | b << 16 texel, byte -> linear."""
    return _unpack_texel(scene.atlas_packed.reshape(-1)[flat.to(torch.int64)])


def atlas_lookup(scene, img_id, u, v) -> V3:
    """Nearest-texel atlas fetch of image ``img_id`` at (u, v)."""
    _, ah, aw = scene.atlas_packed.shape
    return atlas_lookup_flat(
        scene, atlas_flat_index(scene.image_dims, (ah, aw), img_id, u, v)
    )
