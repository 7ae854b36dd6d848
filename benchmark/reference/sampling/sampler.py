"""Pixel-sampler framework (counterpart of ``sampling/sampler.py``): one
enum, three strategies, batched over rays.

  * independent: offsets uniform in [-0.5, 0.5]^2;
  * stratified: jittered sqrt(spp) x sqrt(spp) grid offsets in [-0.5, 0.5]^2;
  * sobol: unscrambled dims 0, 1 of the global Sobol sequence remapped to a
    [0, 1)^2 in-pixel offset via ``sobol_interval_to_index``.
"""

from __future__ import annotations

import enum
import math as _math

import torch

from ..dtypes import ONE_MINUS_EPS, real
from . import hashrng
from . import sobol as _sobol

_SITE_PIXEL = 0  # camera stream site for stochastic pixel jitter


class SamplerKind(enum.Enum):
    INDEPENDENT = "independent"
    STRATIFIED = "stratified"
    SOBOL = "sobol"


def sobol_log2_scale(width: int, height: int) -> int:
    """log2 of the pixel-space Sobol domain (the image's ceil power of 2)."""
    return _sobol.ceil_pow2(max(width, height)).bit_length() - 1


def pixel_offsets(
    kind: SamplerKind,
    seed,
    ray_id: torch.Tensor,
    px: torch.Tensor,
    py: torch.Tensor,
    sample_idx: torch.Tensor,
    spp: int,
    width: int,
    height: int,
):
    """Per-ray (ox, oy) sub-pixel offsets, batched over rays."""
    if kind == SamplerKind.INDEPENDENT:
        u1, u2, _, _ = hashrng.uniform4(seed, ray_id, _SITE_PIXEL)
        return u1 - 0.5, u2 - 0.5

    if kind == SamplerKind.STRATIFIED:
        sqrt_spp = max(1, int(_math.sqrt(spp)))
        recip = 1.0 / sqrt_spp
        sample_idx = sample_idx.to(torch.int64)
        si = torch.div(sample_idx, sqrt_spp, rounding_mode="floor").to(real)
        sj = torch.remainder(sample_idx, sqrt_spp).to(real)
        u1, u2, _, _ = hashrng.uniform4(seed, ray_id, _SITE_PIXEL)
        return (u1 + si) * recip - 0.5, (u2 + sj) * recip - 0.5

    if kind == SamplerKind.SOBOL:
        log2_scale = sobol_log2_scale(width, height)
        idx = _sobol.sobol_interval_to_index(log2_scale, sample_idx, px, py)
        fscale = float(1 << log2_scale)
        sx = _sobol.sobol_sample(idx, 0)
        sy = _sobol.sobol_sample(idx, 1)
        ox = torch.clamp(sx * fscale - px.to(real), 0.0, ONE_MINUS_EPS)
        oy = torch.clamp(sy * fscale - py.to(real), 0.0, ONE_MINUS_EPS)
        return ox, oy

    raise ValueError(f"unknown sampler kind: {kind}")


def sample_dimension(idx: torch.Tensor, dimension: int, seed, scramble: bool = True):
    """Scrambled Sobol sample for dimensions >= 2: the scramble seed is
    Murmur2(dimension, seed) feeding the Owen-fast hash."""
    dimension = dimension % _sobol.N_SOBOL_DIMENSIONS
    if not scramble:
        return _sobol.sobol_sample(idx, dimension)
    h = _sobol.murmur2_32(dimension, seed)
    return _sobol.sobol_sample(idx, dimension, scramble_seed=h)
