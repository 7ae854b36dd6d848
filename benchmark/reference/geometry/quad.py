"""Batched ray/parallelogram intersection and light-sampling PDFs
(counterpart of ``geometry/quad.py``; same formulas, same operation order)."""

from __future__ import annotations

import torch

from ..dtypes import INF, QUAD_PARALLEL_EPS
from ..math import v3
from ..math.v3 import V3


def hit_t(
    start: V3,
    normal: V3,   # unit plane normal
    w: V3,        # basis w = n_raw / |n_raw|^2
    edge_u: V3,
    edge_v: V3,
    offset,       # plane offset = n_unit . start
    origin: V3,
    direction: V3,
    t_min,
    t_max,
):
    """Returns (t, alpha, beta, valid); t is +inf where invalid.  Inclusive
    interval test; alpha/beta as triple products p.(v x w), p.(w x u)."""
    denom = v3.dot(normal, direction)
    not_parallel = torch.abs(denom) >= QUAD_PARALLEL_EPS
    t = (offset - v3.dot(normal, origin)) / torch.where(not_parallel, denom, 1.0)
    in_range = (t >= t_min) & (t <= t_max)
    planar = origin + direction * t - start
    alpha = v3.dot(planar, v3.cross(edge_v, w))
    beta = v3.dot(planar, v3.cross(w, edge_u))
    interior = (alpha >= 0.0) & (alpha <= 1.0) & (beta >= 0.0) & (beta <= 1.0)
    valid = not_parallel & in_range & interior
    return torch.where(valid, t, INF), alpha, beta, valid


def pdf_value(
    start: V3, normal: V3, w: V3, edge_u: V3, edge_v: V3, offset, area,
    origin: V3, direction: V3, t_min,
):
    """dist^2 / (cos * area), 0 on miss."""
    t, _, _, valid = hit_t(
        start, normal, w, edge_u, edge_v, offset, origin, direction, t_min, INF,
    )
    dir_len_sq = v3.dot(direction, direction)
    dist_sq = t * t * dir_len_sq
    cos = torch.abs(v3.dot(direction, normal)) / torch.sqrt(dir_len_sq)
    val = dist_sq / torch.clamp(cos * area, min=1e-20)
    return torch.where(valid, val, 0.0)


def sample_direction(start: V3, edge_u: V3, edge_v: V3, origin: V3, u1, u2) -> V3:
    """Uniform point on the parallelogram minus origin."""
    return start + edge_u * u1 + edge_v * u2 - origin
