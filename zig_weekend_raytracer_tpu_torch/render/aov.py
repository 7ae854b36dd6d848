"""First-hit AOVs (arbitrary output variables): albedo, normal, depth
(counterpart of ``render/aov.py``).

One bounce of the existing machinery produces them: camera rays
(``render/camera.py:generate_rays``, jitter, depth of field and time
included), the closest hit (``ops/closest_hit.py``: the closest-hit kernel
on the card, its plain version on the CPU), then ``shade_attrs`` and
``texture_rgb`` (the shade record) as plain torch on the same device.

Buffers, each summed over a pixel's samples and divided as the JAX
package divides:

  * ``albedo`` (H, W, 3): texture or material colour at the first hit over
    all samples, misses reading the scene background and dielectrics white
    (specular transmission carries no albedo);
  * ``normal`` (H, W, 3): the front-facing shading normal, zero on a miss,
    averaged over the hitting samples and not renormalized;
  * ``depth`` (H, W): the hit distance t along the unnormalized camera ray,
    averaged over the hitting samples; 0 where nothing hits;
  * ``coverage`` (H, W): the fraction of samples that hit anything.

``render_aovs`` returns them as float32 tensors on the scene's device (the
JAX package returns numpy arrays).  ``write_aovs`` writes them as PNGs
through ``io/png.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..dtypes import INF, T_MIN, real
from ..io.png import write_png
from ..io.ppm import encode_pixels
from ..math.v3 import V3
from ..ops.closest_hit import closest_hit
from ..ops.shade import shade_attrs
from ..sampling.sampler import SamplerKind
from ..scene import MAT_DIELECTRIC
from .camera import camera_params, generate_rays
from .integrator import texture_rgb
from .renderer import MAX_RAYS_PER_CHUNK, pick_tile, ray_grid, unflatten_radiance


def band_rays(scene, cam, seed, band_y0, *, width, height, band_rows, spp, sampler, has_dof):
    """The camera rays (origin, direction, time) of one row band, in
    ``ray_grid`` order, on the scene's device."""
    px, py, sidx, ray_id = ray_grid(
        width, height, band_y0, band_rows, 0, spp, pick_tile(width, band_rows),
        device=scene.compiled.device,
    )
    return generate_rays(cam, has_dof, sampler, seed, ray_id, px, py, sidx, spp, width, height)


def _aov_band(scene, cam, seed, band_y0, *, width, height, band_rows, spp, sampler, has_dof):
    """One row band of first-hit AOVs: per-pixel sums over samples of
    (albedo, normal, (depth * hit, hit, 0)), each (band_rows, W, 3)."""
    cs = scene.compiled
    tile = pick_tile(width, band_rows)
    origin, direction, time = band_rays(
        scene, cam, seed, band_y0, width=width, height=height, band_rows=band_rows, spp=spp,
        sampler=sampler, has_dof=has_dof,
    )
    hit = closest_hit(cs, origin, direction, time, T_MIN, INF)
    det = shade_attrs(cs, hit, origin, direction, time)
    hitmask = hit.kind >= 0

    alb = texture_rgb(cs, det)[0]
    alb = V3.where(det.mat_type == MAT_DIELECTRIC, V3.full(alb.shape, 1.0, 1.0, 1.0, cs.device),
                   alb)
    alb = V3.where(hitmask, alb, cs.background)
    nrm = V3.where(hitmask, det.normal, V3.zeros(alb.shape, cs.device))
    t = torch.where(hitmask, hit.t, 0.0)

    def acc(arr3):  # (N, 3) in ray order -> (band_rows, W, 3) pixel sums
        return unflatten_radiance(arr3, width, band_rows, spp, tile).sum(0)

    aux = torch.stack([t, hitmask.to(real), torch.zeros_like(t)], dim=-1)
    return acc(alb.to_array()), acc(nrm.to_array()), acc(aux)


def render_aovs(
    scene, width: int, height: int, *, spp: int = 4, seed: int = 0,
    sampler: SamplerKind = SamplerKind.SOBOL, max_rays_per_chunk: int = MAX_RAYS_PER_CHUNK,
) -> dict:
    """First-hit AOV buffers of ``scene`` (module doc): albedo (H, W, 3),
    normal (H, W, 3), depth (H, W) and coverage (H, W), float32 tensors on
    the scene's device."""
    cam = camera_params(scene.camera, width, height)
    band_rows = max(1, min(height, max_rays_per_chunk // (width * spp)))
    n_bands = -(-height // band_rows)
    # The JAX package narrows its TPU tiles for this pass
    # (CompiledScene.with_rows(8)); a tile height is a TPU setting, and the
    # closest-hit kernel takes rays one thread each, so none is carried over.
    dev = scene.compiled.device
    albedo = torch.zeros((height, width, 3), dtype=real, device=dev)
    normal = torch.zeros((height, width, 3), dtype=real, device=dev)
    depth = torch.zeros((height, width), dtype=real, device=dev)
    coverage = torch.zeros((height, width), dtype=real, device=dev)
    for b in range(n_bands):
        y0 = b * band_rows
        rows = min(band_rows, height - y0)
        alb, nrm, aux = _aov_band(
            scene, cam, seed, y0, width=width, height=height, band_rows=band_rows, spp=spp,
            sampler=sampler, has_dof=scene.camera.has_depth_of_field,
        )
        aux = aux[:rows]
        hits = aux[..., 1]
        safe = torch.clamp(hits, min=1.0)
        albedo[y0 : y0 + rows] = alb[:rows] / spp
        normal[y0 : y0 + rows] = nrm[:rows] / safe[..., None]
        depth[y0 : y0 + rows] = aux[..., 0] / safe
        coverage[y0 : y0 + rows] = hits / spp
    return {"albedo": albedo, "normal": normal, "depth": depth, "coverage": coverage}


def _numpy(a) -> np.ndarray:
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def write_aovs(prefix: str, aovs: dict) -> list:
    """Write AOV buffers as PNGs: ``<prefix>.albedo.png`` (gamma 2, as the
    beauty image), ``<prefix>.normal.png`` (0.5 + 0.5 n) and
    ``<prefix>.depth.png`` (over the largest depth).  Returns the paths."""
    paths = []

    def save(name, arr_u8):
        p = f"{prefix}.{name}.png"
        write_png(p, arr_u8)
        paths.append(p)

    save("albedo", encode_pixels(_numpy(aovs["albedo"])))
    nrm = np.clip(0.5 + 0.5 * _numpy(aovs["normal"]), 0.0, 1.0)
    save("normal", (nrm * 255.0 + 0.5).astype(np.uint8))
    d = _numpy(aovs["depth"])
    dmax = float(d.max()) or 1.0
    save("depth", (np.clip(d / dmax, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8))
    return paths
