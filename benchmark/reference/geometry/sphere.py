"""Batched ray/sphere intersection, UVs and light-sampling PDFs (counterpart
of ``geometry/sphere.py``; same formulas, same operation order)."""

from __future__ import annotations

import math

import torch

from ..dtypes import INF
from ..math import v3
from ..math.v3 import V3
from ..sampling import hashrng


def hit_t(center: V3, radius, origin: V3, direction: V3, t_min, t_max):
    """Returns (t, valid); t is +inf where invalid.  Strict interval test."""
    oc = center - origin
    a = v3.dot(direction, direction)
    h = v3.dot(direction, oc)
    c = v3.dot(oc, oc) - radius * radius
    disc = h * h - a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    inv_a = 1.0 / a
    root1 = (h - sq) * inv_a
    root2 = (h + sq) * inv_a
    in1 = (root1 > t_min) & (root1 < t_max)
    in2 = (root2 > t_min) & (root2 < t_max)
    root = torch.where(in1, root1, root2)
    valid = (disc >= 0.0) & (in1 | in2)
    return torch.where(valid, root, INF), valid


def uv(normal_obj: V3):
    """Spherical UVs from the object-space outward normal."""
    theta = torch.arccos(torch.clamp(-normal_obj.y, -1.0, 1.0))
    phi = torch.atan2(-normal_obj.z, normal_obj.x) + math.pi
    return phi * (0.5 / math.pi), theta * (1.0 / math.pi)


def pdf_value(center: V3, radius, origin: V3, direction: V3, hit_valid):
    """1 / cone solid angle, 0 on miss."""
    diff = center - origin
    dist_sq = v3.dot(diff, diff)
    cos_theta_max = torch.sqrt(torch.clamp(1.0 - radius * radius / dist_sq, min=0.0))
    solid_angle = 2.0 * math.pi * (1.0 - cos_theta_max)
    return torch.where(hit_valid, 1.0 / torch.clamp(solid_angle, min=1e-20), 0.0)


def sample_direction(center: V3, radius, origin: V3, u1, u2) -> V3:
    """Uniform direction in the sphere's visible cone."""
    direction = center - origin
    dist_sq = v3.dot(direction, direction)
    cos_theta_max = torch.sqrt(torch.clamp(1.0 - radius * radius / dist_sq, min=0.0))
    local = hashrng.cone_direction_z(u1, u2, cos_theta_max)
    basis = v3.ortho_basis(direction)
    return v3.onb_transform(basis, local)
