"""Content-addressed RNG: stateless PCG4D hash uniforms keyed by
(seed, ray_id, stream) — counterpart of ``sampling/hashrng.py``, bitwise
equal to it.

torch has little unsigned 32-bit arithmetic, so u32 values travel as int64
tensors holding values in [0, 2^32).  Every ``*`` and ``+`` is followed by
``& 0xFFFFFFFF``: an int64 product that wraps keeps its low 32 bits, so the
masked result is the exact u32 result.  The CUDA kernel uses ``uint32_t``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..dtypes import real
from ..math import v3 as _v3
from ..math.v3 import V3

U32_MASK = 0xFFFFFFFF
_MUL = 1664525
_ADD = 1013904223
_D_INIT = 0x9E3779B9
TWO_PI = 6.283185307179586

# Russian roulette's survival floor (the JAX package's
# sampling/hashrng.py:RR_P_MIN): p = clamp(max(throughput), RR_P_MIN, 1)
# bounds a survivor's weight at 1 / RR_P_MIN.
RR_P_MIN = 0.05


def as_u32(v, like: torch.Tensor) -> torch.Tensor:
    """Int / tensor -> int64 tensor of u32 values, broadcast to ``like``."""
    if isinstance(v, torch.Tensor):
        t = v.to(torch.int64)
    else:
        t = torch.tensor(int(v), dtype=torch.int64, device=like.device)
    return torch.broadcast_to(t & U32_MASK, like.shape)


def pcg4d(a, b, c, d) -> Tuple[torch.Tensor, ...]:
    """PCG4D mix of four u32 (int64-held) tensors -> four u32 tensors."""
    m = U32_MASK
    a = (a * _MUL + _ADD) & m
    b = (b * _MUL + _ADD) & m
    c = (c * _MUL + _ADD) & m
    d = (d * _MUL + _ADD) & m
    a = (a + b * d) & m
    b = (b + c * a) & m
    c = (c + a * b) & m
    d = (d + b * c) & m
    a = a ^ (a >> 16)
    b = b ^ (b >> 16)
    c = c ^ (c >> 16)
    d = d ^ (d >> 16)
    a = (a + b * d) & m
    b = (b + c * a) & m
    c = (c + a * b) & m
    d = (d + b * c) & m
    return a, b, c, d


def _to_unit(v: torch.Tensor) -> torch.Tensor:
    """u32 -> [0, 1) float32 from the top 24 bits (exact, never 1.0)."""
    return (v >> 8).to(real) * (1.0 / (1 << 24))


def uniform4(seed, ray_id: torch.Tensor, stream) -> Tuple[torch.Tensor, ...]:
    """Four independent U[0,1) streams per ray.  ``ray_id`` is an int64
    tensor of u32 values; ``seed`` and ``stream`` are ints or tensors."""
    ray_id = ray_id.to(torch.int64)
    a, b, c, d = pcg4d(
        ray_id,
        as_u32(stream, ray_id),
        as_u32(seed, ray_id),
        torch.full_like(ray_id, _D_INIT),
    )
    return _to_unit(a), _to_unit(b), _to_unit(c), _to_unit(d)


def uniform1(seed, ray_id, stream) -> torch.Tensor:
    return uniform4(seed, ray_id, stream)[0]


def gauss3(seed, ray_id, stream) -> V3:
    """Three standard normals per ray via Box-Muller."""
    u1, u2, u3, u4 = uniform4(seed, ray_id, stream)
    r1 = torch.sqrt(-2.0 * torch.log(torch.clamp(u1, min=1e-10)))
    r2 = torch.sqrt(-2.0 * torch.log(torch.clamp(u3, min=1e-10)))
    return V3(
        r1 * torch.cos(TWO_PI * u2),
        r1 * torch.sin(TWO_PI * u2),
        r2 * torch.cos(TWO_PI * u4),
    )


def gauss2(seed, ray_id, stream) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two standard normals per ray via Box-Muller."""
    u1, u2, _, _ = uniform4(seed, ray_id, stream)
    r = torch.sqrt(-2.0 * torch.log(torch.clamp(u1, min=1e-10)))
    return r * torch.cos(TWO_PI * u2), r * torch.sin(TWO_PI * u2)


def unit_disk_xy(u_radius, gx, gy):
    """Point in the unit disk: radius-uniform ``u_radius`` times the
    normalized 2D gaussian (gx, gy)."""
    norm = torch.sqrt(torch.clamp(gx * gx + gy * gy, min=1e-24))
    return u_radius * gx / norm, u_radius * gy / norm


def unit_sphere(g: V3) -> V3:
    """Gaussian-normalize direct sampling."""
    norm = torch.sqrt(torch.clamp(_v3.dot(g, g), min=1e-24))
    return g * (1.0 / norm)


def cosine_direction_z(u1, u2) -> V3:
    """Cosine-weighted hemisphere about +z."""
    phi = TWO_PI * u1
    sq = torch.sqrt(u2)
    return V3(torch.cos(phi) * sq, torch.sin(phi) * sq, torch.sqrt(1.0 - u2))


def cone_direction_z(u1, u2, cos_theta_max) -> V3:
    """Uniform in the z-cone (sphere-light sampling)."""
    z = 1.0 + u2 * (cos_theta_max - 1.0)
    phi = TWO_PI * u1
    sz2 = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return V3(torch.cos(phi) * sz2, torch.sin(phi) * sz2, z)
