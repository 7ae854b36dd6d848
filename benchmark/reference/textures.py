"""Texture evaluation (counterpart of ``textures.py``): solid colours come
straight from the shade record; a checker picks one of its two record
colours by the 3D lattice parity of the hit point; an image is a
nearest-texel fetch, byte -> linear by the gamma-2 square, from the
scene's packed atlas (``atlas_*``) or, when the scene has one, from its
texture LUT (``lut_*``).

``texture_value`` is the general walk over the texture table, which
scenes with nested checkers (a checker of checkers) shade with: checkers
resolve to their parity-selected child for ``_CHECKER_MAX_DEPTH`` levels,
then the texture gives its solid colour or its texel, always from the
atlas (the LUT is a lossy copy), as the JAX package's walk does."""

from __future__ import annotations

import torch

from .dtypes import real
from .math.v3 import V3
from .scene import TEX_CHECKER, TEX_IMAGE

_INV_255 = float(torch.tensor(1.0 / 255.0, dtype=real))
# checker levels the general walk resolves (the reference recurses; real
# scenes nest a checker in a checker at most)
_CHECKER_MAX_DEPTH = 4


def checker_parity(inv_scale, point: V3) -> torch.Tensor:
    """3D lattice parity of the scaled hit point.  0 = even, 1 = odd."""
    xi = torch.floor(inv_scale * point.x).to(torch.int32)
    yi = torch.floor(inv_scale * point.y).to(torch.int32)
    zi = torch.floor(inv_scale * point.z).to(torch.int32)
    return torch.remainder(xi + yi + zi, 2)


def _flat_index(dims, img_id, u, v) -> torch.Tensor:
    """(u, v, image) -> flat texel index into an image table from the static
    per-image (width, height, base, row stride): u and v clamped to [0, 1],
    v flipped to image rows, the texel coordinate truncated and clamped to
    the image (the kernels' zwrt_device.cuh:image_texel)."""
    w = torch.zeros_like(u)
    h = torch.zeros_like(u)
    wi = torch.zeros_like(img_id)
    hi = torch.zeros_like(img_id)
    base = torch.zeros_like(img_id)
    stride = torch.zeros_like(img_id)
    for i, (iw, ih, ib, st) in enumerate(dims):
        sel = img_id == i
        w = torch.where(sel, float(iw), w)
        h = torch.where(sel, float(ih), h)
        wi = torch.where(sel, iw, wi)
        hi = torch.where(sel, ih, hi)
        base = torch.where(sel, ib, base)
        stride = torch.where(sel, st, stride)
    uc = torch.clamp(u, 0.0, 1.0)
    vc = 1.0 - torch.clamp(v, 0.0, 1.0)  # flip to image rows
    x = torch.minimum(torch.clamp((uc * w).to(torch.int32), min=0), wi - 1)
    y = torch.minimum(torch.clamp((vc * h).to(torch.int32), min=0), hi - 1)
    return base + y * stride + x


def _atlas_dims(image_dims, ah, aw):
    """The atlas's (width, height, base, row stride) per image: image i at
    i * ah * aw, rows aw apart."""
    return [(w, h, i * ah * aw, aw) for i, (w, h) in enumerate(image_dims)]


def _lut_dims(lut_dims):
    """The texture LUT's (width, height, base, row stride) per image: each
    image unpadded at its own base, rows its own width apart."""
    return [(w, h, base, w) for w, h, base in lut_dims]


def _unpack_texel(packed) -> V3:
    texel = V3(
        (packed & 0xFF).to(real) * _INV_255,
        ((packed >> 8) & 0xFF).to(real) * _INV_255,
        ((packed >> 16) & 0xFF).to(real) * _INV_255,
    )
    return texel * texel  # gamma-2 linearize


def _lookup(dims, texels, img_id, u, v) -> V3:
    """One gather of the r | g << 8 | b << 16 texel, byte -> linear."""
    return _unpack_texel(texels[_flat_index(dims, img_id, u, v).to(torch.int64)])


def image_table(scene):
    """(dims, texels) of the image table that a scene's texel fetch reads:
    the texture LUT when the scene has one, else the atlas, with each
    image's (width, height, base, row stride); ``texels`` is flat int32."""
    if scene.tex_lut_dims:
        return _lut_dims(scene.tex_lut_dims), scene.tex_lut_tab
    _, ah, aw = scene.atlas_packed.shape
    return _atlas_dims(scene.image_dims, ah, aw), scene.atlas_packed.reshape(-1)


def image_lookup(scene, img_id, u, v) -> V3:
    """Nearest-texel fetch of image ``img_id`` at (u, v) from the scene's
    image table (``image_table``)."""
    return _lookup(*image_table(scene), img_id, u, v)


def atlas_flat_index(image_dims, atlas_hw, img_id, u, v) -> torch.Tensor:
    """(u, v, image) -> flat index into the packed atlas plane from the
    static per-image (width, height)."""
    return _flat_index(_atlas_dims(image_dims, *atlas_hw), img_id, u, v)


def atlas_lookup(scene, img_id, u, v) -> V3:
    """Nearest-texel atlas fetch of image ``img_id`` at (u, v)."""
    _, ah, aw = scene.atlas_packed.shape
    return _lookup(_atlas_dims(scene.image_dims, ah, aw), scene.atlas_packed.reshape(-1),
                   img_id, u, v)


def lut_flat_index(lut_dims, img_id, u, v) -> torch.Tensor:
    """(u, v, image) -> flat index into the texture LUT from the static
    per-image (width, height, base)."""
    return _flat_index(_lut_dims(lut_dims), img_id, u, v)


def lut_lookup(scene, img_id, u, v) -> V3:
    """Nearest-texel fetch of image ``img_id`` at (u, v) from the scene's
    texture LUT."""
    return _lookup(_lut_dims(scene.tex_lut_dims), scene.tex_lut_tab, img_id, u, v)


def _resolve_checker(scene, tex_id, point: V3) -> torch.Tensor:
    """Each checker texture id redirected to its parity-selected child,
    ``_CHECKER_MAX_DEPTH`` times; other ids stay."""
    for _ in range(_CHECKER_MAX_DEPTH):
        t = tex_id.to(torch.int64)
        parity = checker_parity(scene.tex_inv_scale[t], point)
        child = torch.where(parity == 0, scene.tex_even[t], scene.tex_odd[t])
        tex_id = torch.where(scene.tex_type[t] == TEX_CHECKER, child, tex_id)
    return tex_id


def texture_value(scene, tex_id, u, v, point: V3) -> V3:
    """Linear colour of texture ``tex_id`` ((N,) int32) at each hit: the
    general walk (module doc).  An image texel comes from the atlas."""
    t = _resolve_checker(scene, tex_id, point).to(torch.int64)
    solid = V3(*(c[t] for c in scene.tex_rgb))
    if not scene.has_image_textures:
        return solid
    image = atlas_lookup(scene, scene.tex_img[t], u, v)
    return V3.where(scene.tex_type[t] == TEX_IMAGE, image, solid)
