"""Closest-hit tracing over the compiled scene tables (counterpart of
``ops/trace.py``): the plain brute-force scan.

Every primitive is tested as broadcast scalars against the (N,) ray lanes,
spheres first, then quads.  A primitive replaces the running best only
with a strictly smaller ``t``, so on equal ``t`` the smallest index of a
kind wins and a quad never displaces a sphere at the same distance: the
tie rules of the CUDA kernel and of the JAX package's Pallas trace.
BVH and group-tree traversal are slice 3 (ROADMAP.md).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..dtypes import INF, real
from ..geometry import quad as quad_g
from ..geometry import sphere as sphere_g
from ..math.v3 import V3
from ..scene import PRIM_QUAD, PRIM_SPHERE, CompiledScene

NO_HIT = -1


class Hit(NamedTuple):
    t: torch.Tensor       # (N,) f32, +inf on miss
    kind: torch.Tensor    # (N,) i32, PRIM_SPHERE / PRIM_QUAD / -1 miss
    idx: torch.Tensor     # (N,) i32 primitive index within its table


def closest_hit_brute(
    scene: CompiledScene, origin: V3, direction: V3, time, t_min, t_max,
) -> Hit:
    """Linear scan over the primitive tables."""
    n = origin.shape[0]
    dev = origin.x.device
    t_best = torch.full((n,), t_max, dtype=real, device=dev)
    kind = torch.full((n,), NO_HIT, dtype=torch.int32, device=dev)
    idx = torch.zeros((n,), dtype=torch.int32, device=dev)

    def keep(t, code, i):
        nonlocal t_best, kind, idx
        closer = t < t_best
        t_best = torch.where(closer, t, t_best)
        kind = torch.where(closer, code, kind)
        idx = torch.where(closer, i, idx)

    for i in range(scene.n_spheres):
        center = scene.sph_center[i]
        if scene.has_moving:
            center = center + scene.sph_move[i] * time
        t, _ = sphere_g.hit_t(
            center, scene.sph_radius[i], origin, direction, t_min, t_best
        )
        keep(t, PRIM_SPHERE, i)
    for i in range(scene.n_quads):
        t, _, _, _ = quad_g.hit_t(
            scene.quad_start[i], scene.quad_normal[i], scene.quad_w[i],
            scene.quad_u[i], scene.quad_v[i], scene.quad_offset[i],
            origin, direction, t_min, t_best,
        )
        keep(t, PRIM_QUAD, i)
    missed = kind == NO_HIT
    return Hit(t=torch.where(missed, INF, t_best), kind=kind, idx=idx)
