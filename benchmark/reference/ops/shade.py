"""Shading-attribute fetch: everything the integrator needs about a hit
(counterpart of ``ops/shade.py``).

Scene compilation denormalizes each primitive's geometry, material and
texture into one 32-column record (``CompiledScene.shade_rows``); a hit
reads its winner's row.  The column layout is the JAX package's, so the
CUDA kernel reads the same table with a plain indexed load.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geometry import sphere as sphere_g
from ..math import v3
from ..math.v3 import V3
from ..scene import PRIM_SPHERE, CompiledScene
from .trace import Hit

# record column layout (kind-specific geometry, shared shading)
# spheres: 0-2 center, 3-5 move, 6 inv_radius, 7 uv_cos, 8 uv_sin
# quads:   0-2 start, 3-5 normal, 6-8 w, 9-11 edge_u, 12-14 edge_v
C_MAT = 16       # material type code
C_TEXKIND = 17   # texture kind code
C_IMG = 18       # atlas image id (-1 = none)
C_RGB = 19       # 19-21: solid / checker-even rgb, metal albedo, emission
C_RGB2 = 22      # 22-24: checker-odd rgb
C_INVSCALE = 25  # checker inverse scale
C_FUZZ = 26
C_REFRACT = 27
C_IMG2 = 28      # checker odd child image id (-1 = none)
C_TEXID = 29     # original texture id
C_MATID = 30     # index of the record's distinct shading block
SHADE_BLOCK = 14  # C_MAT..C_TEXID: the per-material shading column span
RECORD_WIDTH = 32


class ShadeAttrs(NamedTuple):
    """Everything the bounce needs about the hit point (all (N,) / V3)."""

    point: V3
    normal: V3            # front-face oriented
    front: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    mat_type: torch.Tensor
    tex_kind: torch.Tensor
    rgb: V3
    rgb2: V3
    inv_scale: torch.Tensor
    fuzz: torch.Tensor
    refract: torch.Tensor
    img: torch.Tensor     # atlas image id of the texture (-1 = none)
    img2: torch.Tensor    # a checker's odd-child image id (-1 = none)
    texid: torch.Tensor   # the material's texture id (the general walk's start)


def build_shade_rows(
    sph_geom: dict, quad_geom: dict, sph_shade: np.ndarray,
    quad_shade: np.ndarray,
) -> np.ndarray:
    """Host-side: pack per-prim records.  ``*_geom`` are dicts of (S,)
    columns; ``*_shade`` are (S, SHADE_BLOCK) shading blocks [mat, texkind,
    img, rgb3, rgb23, inv_scale, fuzz, refract, img2, texid]."""
    s = sph_shade.shape[0]
    q = quad_shade.shape[0]
    rows = np.zeros((s + q, RECORD_WIDTH), np.float32)
    if s:
        for c, k in enumerate(("cx", "cy", "cz", "mx", "my", "mz")):
            rows[:s, c] = sph_geom[k]
        with np.errstate(divide="ignore"):
            rows[:s, 6] = np.where(
                sph_geom["r"] > 0, 1.0 / np.maximum(sph_geom["r"], 1e-20), 0.0
            )
        rows[:s, 7] = sph_geom["uv_cos"]
        rows[:s, 8] = sph_geom["uv_sin"]
        rows[:s, C_MAT : C_MAT + SHADE_BLOCK] = sph_shade
    if q:
        for c, k in enumerate(("sx", "sy", "sz", "nx", "ny", "nz", "wx", "wy",
                               "wz", "ux", "uy", "uz", "vx", "vy", "vz")):
            rows[s:, c] = quad_geom[k]
        rows[s:, C_MAT : C_MAT + SHADE_BLOCK] = quad_shade
    return rows


def dedupe_material_ids(shade_rows: np.ndarray) -> None:
    """Write each record's distinct-shading-block index into C_MATID (in
    place), numbering the blocks in ``np.unique`` order as the JAX package
    does."""
    block = shade_rows[:, C_MAT : C_MAT + SHADE_BLOCK]
    _, inv = np.unique(block, axis=0, return_inverse=True)
    shade_rows[:, C_MATID] = inv.reshape(-1).astype(np.float32)


def shade_attrs(
    scene: CompiledScene, hit: Hit, origin: V3, direction: V3, time,
) -> ShadeAttrs:
    """Fetch ShadeAttrs for the winning primitive of each ray: one row
    gather of ``shade_rows`` (misses read a valid row; callers mask)."""
    is_sphere = hit.kind == PRIM_SPHERE
    uidx = torch.where(is_sphere, hit.idx, scene.n_spheres + hit.idx)
    uidx = torch.clamp(uidx, 0, scene.shade_rows.shape[0] - 1).to(torch.int64)
    cols = scene.shade_rows[uidx].T

    safe_t = torch.where(torch.isfinite(hit.t), hit.t, 0.0)
    point = origin + direction * safe_t

    # -- sphere geometry --
    center = V3(cols[0], cols[1], cols[2])
    move = V3(cols[3], cols[4], cols[5])
    center = center + move * time
    n_sph = (point - center) * cols[6]
    c_rot = cols[7]
    s_rot = cols[8]
    n_obj = V3(
        c_rot * n_sph.x - s_rot * n_sph.z,
        n_sph.y,
        s_rot * n_sph.x + c_rot * n_sph.z,
    )
    u_sph, v_sph = sphere_g.uv(n_obj)

    # -- quad geometry --
    q_start = V3(cols[0], cols[1], cols[2])
    q_normal = V3(cols[3], cols[4], cols[5])
    q_w = V3(cols[6], cols[7], cols[8])
    q_u = V3(cols[9], cols[10], cols[11])
    q_v = V3(cols[12], cols[13], cols[14])
    planar = point - q_start
    alpha = v3.dot(q_w, v3.cross(planar, q_v))
    beta = v3.dot(q_w, v3.cross(q_u, planar))

    outward = V3.where(is_sphere, n_sph, q_normal)
    front = v3.dot(direction, outward) < 0.0
    return ShadeAttrs(
        point=point,
        normal=V3.where(front, outward, -outward),
        front=front,
        u=torch.where(is_sphere, u_sph, alpha),
        v=torch.where(is_sphere, v_sph, beta),
        mat_type=cols[C_MAT].to(torch.int32),
        tex_kind=cols[C_TEXKIND].to(torch.int32),
        rgb=V3(cols[C_RGB], cols[C_RGB + 1], cols[C_RGB + 2]),
        rgb2=V3(cols[C_RGB2], cols[C_RGB2 + 1], cols[C_RGB2 + 2]),
        inv_scale=cols[C_INVSCALE],
        fuzz=cols[C_FUZZ],
        refract=cols[C_REFRACT],
        img=cols[C_IMG].to(torch.int32),
        img2=cols[C_IMG2].to(torch.int32),
        texid=cols[C_TEXID].to(torch.int32),
    )
