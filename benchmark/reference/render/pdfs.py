"""Light-list importance sampling (counterpart of ``render/pdfs.py``): the
evenly weighted mixture of per-light surface PDFs, and a direction toward a
uniformly chosen light.  The light list is static scene metadata."""

from __future__ import annotations

import torch

from ..dtypes import INF, T_MIN_PDF
from ..geometry import quad as quad_g
from ..geometry import sphere as sphere_g
from ..math.v3 import V3
from ..scene import PRIM_SPHERE, CompiledScene


def _slot_pdf(scene, kind, idx, origin, direction):
    if kind == PRIM_SPHERE:
        center = scene.sph_center[idx]
        radius = scene.sph_radius[idx]
        _, valid = sphere_g.hit_t(center, radius, origin, direction, T_MIN_PDF, INF)
        return sphere_g.pdf_value(center, radius, origin, direction, valid)
    return quad_g.pdf_value(
        scene.quad_start[idx], scene.quad_normal[idx], scene.quad_w[idx],
        scene.quad_u[idx], scene.quad_v[idx], scene.quad_offset[idx],
        scene.quad_area[idx], origin, direction, T_MIN_PDF,
    )


def light_pdf_value(scene: CompiledScene, origin: V3, direction: V3) -> torch.Tensor:
    """(N,) mixture-member PDF of the scene's light list (sphere lights are
    taken as stationary)."""
    total = torch.zeros(origin.shape, dtype=origin.x.dtype, device=origin.x.device)
    for kind, idx in scene.lights:
        total = total + _slot_pdf(scene, kind, idx, origin, direction)
    # A tensor divisor: CUDA torch turns division by a Python scalar into a
    # multiply by its reciprocal, one rounding off the kernels' division
    # whenever the light count is not a power of two.
    return total / torch.full_like(total, len(scene.lights))


def sample_light_direction(scene: CompiledScene, origin: V3, u_choice, u1, u2) -> V3:
    """Direction toward a uniformly chosen light."""
    n_l = len(scene.lights)
    chosen = torch.clamp((u_choice * n_l).to(torch.int32), max=n_l - 1)
    out = None
    for l, (kind, idx) in enumerate(scene.lights):
        if kind == PRIM_SPHERE:
            d = sphere_g.sample_direction(
                scene.sph_center[idx], scene.sph_radius[idx], origin, u1, u2
            )
        else:
            d = quad_g.sample_direction(
                scene.quad_start[idx], scene.quad_u[idx], scene.quad_v[idx],
                origin, u1, u2,
            )
        out = d if out is None else V3.where(chosen == l, d, out)
    return out
