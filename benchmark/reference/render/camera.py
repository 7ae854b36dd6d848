"""Camera ray generation for a wavefront of (pixel, sample) pairs
(counterpart of ``render/camera.py``).

hashrng stream sites 0..3 are reserved for the camera (pixel jitter,
defocus disk, time); bounce streams start at 8 (see integrator.py).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..dtypes import real
from ..math.v3 import V3
from ..sampling import hashrng
from ..sampling.sampler import SamplerKind, pixel_offsets
from ..scene import Camera

SITE_PIXEL = 0
SITE_DOF = 1
SITE_TIME = 2


class CameraParams(NamedTuple):
    """Camera constants as V3s of Python floats (the float32 values)."""

    position: V3
    pixel00: V3
    delta_u: V3
    delta_v: V3
    defocus_u: V3
    defocus_v: V3


def camera_consts(camera: Camera, width: int, height: int):
    """Camera constants as a nested tuple of floats: (position, pixel00,
    delta_u, delta_v, defocus_u, defocus_v), each float32-valued."""
    pixel00, du, dv = camera.viewport(width, height)
    dd_u, dd_v = camera.defocus_disk()

    def t3(a):
        return tuple(float(v) for v in np.asarray(a, np.float32))

    return (
        t3(camera.look_from), t3(pixel00), t3(du), t3(dv), t3(dd_u), t3(dd_v)
    )


def camera_params_from_consts(consts) -> CameraParams:
    return CameraParams(*(V3(*t) for t in consts))


def camera_params(camera: Camera, width: int, height: int) -> CameraParams:
    return camera_params_from_consts(camera_consts(camera, width, height))


def generate_rays(
    cam: CameraParams,
    has_dof: bool,
    sampler: SamplerKind,
    seed,
    ray_id: torch.Tensor,      # (N,) int64 u32 global ray id
    px: torch.Tensor,          # (N,) pixel column
    py: torch.Tensor,          # (N,) pixel row
    sample_idx: torch.Tensor,  # (N,)
    spp: int,
    width: int,
    height: int,
):
    """Returns (origin V3, direction V3, time (N,)).  With ``has_dof`` the
    origin is a point of the defocus disk: radius from uniform4(SITE_DOF),
    angle from the gaussian pair at SITE_DOF + 4."""
    ox, oy = pixel_offsets(sampler, seed, ray_id, px, py, sample_idx, spp, width, height)
    sample_pos = (
        cam.pixel00
        + cam.delta_u * (px.to(real) + ox)
        + cam.delta_v * (py.to(real) + oy)
    )
    shape = px.shape
    origin = V3(*(
        torch.full(shape, c, dtype=real, device=px.device) for c in cam.position
    ))
    if has_dof:
        ud, _, _, _ = hashrng.uniform4(seed, ray_id, SITE_DOF)
        gx, gy = hashrng.gauss2(seed, ray_id, SITE_DOF + 4)
        dx, dy = hashrng.unit_disk_xy(ud, gx, gy)
        origin = origin + cam.defocus_u * dx + cam.defocus_v * dy
    direction = sample_pos - origin
    time = hashrng.uniform1(seed, ray_id, SITE_TIME)
    return origin, direction, time
