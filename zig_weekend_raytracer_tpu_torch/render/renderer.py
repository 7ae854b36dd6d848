"""Render driver (counterpart of ``render/renderer.py``, regenerating path).

An image renders as row bands; each band is one call of
``render/integrator.py:trace_paths_regen`` over lanes that each own one
pixel: one launch of the fused render kernel (``ops/fused_render.py``), or
for image-texture scenes of the bounce kernel's regenerating mode
(``ops/bounce.py``).  With one sample in flight per pixel (s_par = 1) the
lanes follow a cached plan:

  * brute scenes: the first render of a (scene, size, config) measures each
    lane's work count; later renders sort pixels by that cost, so each warp
    holds lanes of similar cost;
  * tree scenes: pixels are ordered by the first hit of their sample-0
    camera ray (``_first_hit_probe``, through the closest-hit kernel), so
    the threads of a warp start in the same part of the tree.

Lane sums are scatter-added into the band.  The content-addressed RNG makes
the image invariant to how samples are assigned to lanes.  Profiler zones
(``utils/profiler.py``, off by default): ``Renderer::render`` around a
render, ``rayColorLine`` around each band's trace.
"""

from __future__ import annotations

import dataclasses
import logging
import weakref
from typing import Optional

import numpy as np
import torch

from ..dtypes import real
from ..ops.closest_hit import closest_hit
from ..sampling.sampler import SamplerKind
from ..scene import Scene
from ..utils.profiler import named_zone
from .camera import camera_consts, camera_params_from_consts, generate_rays
from .integrator import trace_paths_regen

log = logging.getLogger("zwrt")

TILE = 32  # pixel-block side for tiled lane order


def pick_tile(width: int, band_rows: int) -> Optional[int]:
    """Tiled lane order when the band is big enough for padding to a TILE
    multiple to be negligible; tiny renders stay flat."""
    if width >= 2 * TILE and band_rows >= TILE:
        return TILE
    return None


def ray_grid(width, height, band_y0, band_rows, sample0, spp_chunk, tile=None,
             device="cpu"):
    """(px, py, sample_idx, ray_id) int64 tensors for one chunk, in
    (sample, y, x) order, or (sample, block_y, block_x, in_y, in_x) order
    with ``tile``.  ray_id = (sample * height + y) * width + x as u32.
    Padded rows and columns are clamped to the last valid pixel."""
    kw = dict(dtype=torch.int64, device=device)
    s = sample0 + torch.arange(spp_chunk, **kw)
    if tile is None:
        y = band_y0 + torch.arange(band_rows, **kw)
        x = torch.arange(width, **kw)
        sg, yg, xg = torch.meshgrid(s, y, x, indexing="ij")
        px = xg.reshape(-1)
        py = torch.clamp(yg.reshape(-1), max=height - 1)
    else:
        rows_p = -(-band_rows // tile) * tile
        width_p = -(-width // tile) * tile
        by = torch.arange(rows_p // tile, **kw)
        bx = torch.arange(width_p // tile, **kw)
        iy = torch.arange(tile, **kw)
        ix = torch.arange(tile, **kw)
        sg, byg, bxg, iyg, ixg = torch.meshgrid(s, by, bx, iy, ix, indexing="ij")
        px = torch.clamp((bxg * tile + ixg).reshape(-1), max=width - 1)
        py = torch.clamp(band_y0 + (byg * tile + iyg).reshape(-1), max=height - 1)
    sidx = sg.reshape(-1)
    ray_id = ((sidx * height + py) * width + px) & 0xFFFFFFFF
    return px, py, sidx, ray_id


def unflatten_radiance(rad, width, band_rows, spp_chunk, tile):
    """(N, 3) radiance in ray_grid order -> (spp_chunk, band_rows, width, 3)
    (reshape/permute; padded pixels sliced off)."""
    if tile is None:
        return rad.reshape(spp_chunk, band_rows, width, 3)
    rows_p = -(-band_rows // tile) * tile
    width_p = -(-width // tile) * tile
    rad = rad.reshape(spp_chunk, rows_p // tile, width_p // tile, tile, tile, 3)
    rad = rad.permute(0, 1, 3, 2, 4, 5).reshape(spp_chunk, rows_p, width_p, 3)
    return rad[:, :band_rows, :width]


def tile_order_lane_index(width, band_rows, tile):
    """(band_rows, width) array of each pixel's lane index in the tiled
    ray_grid order (s_par = 1), accounting for tile padding."""
    if tile is None:
        return np.arange(band_rows * width).reshape(band_rows, width)
    nbx = -(-width // tile)
    y = np.arange(band_rows)[:, None]
    x = np.arange(width)[None, :]
    by, iy = y // tile, y % tile
    bx, ix = x // tile, x % tile
    return (((by * nbx + bx) * tile + iy) * tile) + ix


def _render_band_regen(
    scene: Scene, seed: int, band_y0: int, sample0: int, *,
    width: int, height: int, band_rows: int, s_par: int, spp: int,
    sample_limit: int, max_depth: int, sampler: SamplerKind, has_dof: bool,
    cam_consts, want_work: bool = False,
):
    """Regenerating band render: each of band_rows * width * s_par lanes
    traces its pixel's samples {sample0 + k + j * s_par} < sample_limit.
    Returns the (band_rows, width, 3) radiance sum, plus the per-lane work
    counts (lane order) when ``want_work``."""
    cs = scene.compiled
    tile = pick_tile(width, band_rows)
    px, py, sidx, _ = ray_grid(
        width, height, band_y0, band_rows, sample0, s_par, tile, device=cs.device
    )
    i32 = torch.int32
    limit = torch.full_like(px, sample_limit, dtype=i32)
    with named_zone("rayColorLine"):
        out = trace_paths_regen(
            cs, cam_consts, seed, px.to(i32), py.to(i32), sidx.to(i32), limit,
            sampler=sampler, width=width, height=height, spp=spp, stride=s_par,
            max_depth=max_depth, has_dof=has_dof, want_work=want_work,
        )
    radiance = out[0] if want_work else out
    fb = unflatten_radiance(
        radiance.to_array(), width, band_rows, s_par, tile
    ).sum(dim=0)
    if want_work:
        return fb, out[1]
    return fb


def _first_hit_probe(
    scene: Scene, seed: int, px, py, *, width: int, height: int, spp: int,
    sampler: SamplerKind, has_dof: bool, cam_consts,
):
    """First-hit (kind, idx) of each pixel's sample-0 camera ray, traced
    with t_min 1e-4 and no shading: the coherence key of tree scenes.
    ``px``, ``py`` are (N,) int64 on the scene's device."""
    cs = scene.compiled
    sidx = torch.zeros_like(px)
    ray_id = py * width + px
    origin, direction, time = generate_rays(
        camera_params_from_consts(cam_consts), has_dof, sampler, seed, ray_id,
        px, py, sidx, spp, width, height,
    )
    hit = closest_hit(cs, origin, direction, time, float(np.float32(1e-4)))
    return hit.kind, hit.idx


def _render_band_balanced(
    scene: Scene, seed: int, band_y0: int, px, py, s0, s1, *,
    width: int, height: int, band_rows: int, spp: int, max_depth: int,
    sampler: SamplerKind, has_dof: bool, cam_consts,
):
    """Plan render: lanes carry explicit (pixel, sample-range) work items;
    per-lane radiance sums are scatter-added into the band framebuffer.
    Each (pixel, sample) pair belongs to one lane, so the sum is the same
    whatever the lane order."""
    cs = scene.compiled
    with named_zone("rayColorLine"):
        radiance = trace_paths_regen(
            cs, cam_consts, seed, px, py, s0, s1, sampler=sampler, width=width,
            height=height, spp=spp, stride=1, max_depth=max_depth,
            has_dof=has_dof,
        )
    pixflat = ((py - band_y0) * width + px).to(torch.int64)
    fb = torch.zeros((band_rows * width, 3), dtype=real, device=cs.device)
    fb.index_add_(0, pixflat, radiance.to_array())
    return fb.reshape(band_rows, width, 3)


@dataclasses.dataclass
class Renderer:
    """User-facing render configuration; field names and defaults are the
    JAX package's.  ``device`` (default: the scene's) must match the scene's
    device; a CUDA device without a GPU raises."""

    samples_per_pixel: int = 10
    max_ray_bounce_depth: int = 20
    sampler: SamplerKind = SamplerKind.SOBOL
    seed: int = 0
    # Max rays in flight per band.
    max_rays_per_chunk: int = 1 << 21
    # Unused by the port (it has no XLA BVH path); kept for field parity.
    max_rays_per_chunk_bvh: int = 1 << 17
    # Russian roulette and the indirect clamp are slice 5 (ROADMAP.md);
    # only the reference semantics (0 = off) are accepted.
    russian_roulette: int = 0
    clamp_indirect: float = 0.0
    # Minimum lanes in flight; beyond it fewer samples per pixel run in
    # parallel (s_par), each lane walking its pixel's samples in sequence.
    regen_min_wave: int = 1 << 17
    # Two-pass profile-guided balancing is not ported (0 = off).
    balance_min_spp: int = 0
    balance_overprovision: float = 1.3
    device: Optional[str] = None
    # Cost maps keyed weakly on the CompiledScene object, each a bounded
    # {config: entry} dict (FIFO eviction); entries die with their scene.
    _plan_cache: "weakref.WeakKeyDictionary" = dataclasses.field(
        default_factory=weakref.WeakKeyDictionary, repr=False, compare=False,
    )
    _plan_cache_max_configs: int = 8

    def __post_init__(self):
        if self.russian_roulette or self.clamp_indirect:
            raise NotImplementedError(
                "Russian roulette and the indirect clamp are slice 5 of the "
                "port (ROADMAP.md)"
            )
        if self.balance_min_spp:
            raise NotImplementedError(
                "two-pass balanced rendering is not ported (ROADMAP.md)"
            )
        if self.device is not None:
            dev = torch.device(self.device)
            if dev.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError(
                    f"Renderer(device={self.device!r}): CUDA is not available"
                )

    def regen_geometry(self, width: int, height: int, spp: int):
        """(s_par, band_rows): just enough samples in flight per pixel to
        reach regen_min_wave lanes, rows capped by max_rays_per_chunk."""
        pixels = max(width * height, 1)
        s_par = max(1, min(spp, -(-self.regen_min_wave // pixels)))
        band_rows = max(1, min(height, self.max_rays_per_chunk // (width * s_par)))
        return s_par, band_rows

    def _render_band_sorted_driver(
        self, scene: Scene, seed: int, band_y0: int, rows_eff: int,
        band_rows: int, width: int, height: int, spp: int, has_dof, cam_c,
    ):
        """Cost-sorted lanes with temporal reuse: the first render of this
        (scene, size, config) runs the plain lane layout with the work count
        as a side output and caches it; later renders sort pixels by that
        cost (a pure pixel permutation)."""
        cs = scene.compiled
        scene_cache = self._plan_cache.get(cs)
        if scene_cache is None:
            scene_cache = self._plan_cache.setdefault(cs, {})
        key = (
            width, height, band_y0, spp,
            self.max_ray_bounce_depth, self.sampler, self.seed,
        )
        entry = scene_cache.get(key)
        if entry is None:
            fb, work = _render_band_regen(
                scene, seed, band_y0, 0, width=width, height=height,
                band_rows=band_rows, s_par=1, spp=spp, sample_limit=spp,
                max_depth=self.max_ray_bounce_depth, sampler=self.sampler,
                has_dof=has_dof, cam_consts=cam_c, want_work=True,
            )
            while len(scene_cache) >= self._plan_cache_max_configs:
                scene_cache.pop(next(iter(scene_cache)))
            scene_cache[key] = {"work": work}
            return fb
        if "plan" not in entry:
            tile = pick_tile(width, band_rows)
            lane_idx = tile_order_lane_index(width, band_rows, tile)
            w = entry.pop("work").cpu().numpy()
            cost = w[lane_idx.reshape(-1)].reshape(band_rows, width)[:rows_eff].reshape(-1)
            ys, xs = np.divmod(np.arange(cost.size), width)
            order = np.argsort(-cost, kind="stable")
            entry["plan"] = tuple(
                torch.as_tensor(np.asarray(a, np.int32), device=cs.device)
                for a in (xs[order], ys[order] + band_y0, np.zeros(cost.size),
                          np.full(cost.size, spp))
            )
        px, py, s0, s1 = entry["plan"]
        return _render_band_balanced(
            scene, seed, band_y0, px, py, s0, s1, width=width, height=height,
            band_rows=band_rows, spp=spp, max_depth=self.max_ray_bounce_depth,
            sampler=self.sampler, has_dof=has_dof, cam_consts=cam_c,
        )

    def _render_band_coherent_driver(
        self, scene: Scene, seed: int, band_y0: int, rows_eff: int,
        band_rows: int, width: int, height: int, spp: int, has_dof, cam_c,
    ):
        """Coherence-sorted lanes for tree scenes: pixels ordered by the
        first-hit key (kind << 24) + idx of their sample-0 ray (misses -1
        first), ties in image-tile order.  Primitives of a leaf sit together
        in the tables, so nearby keys start in the same part of the tree.
        The plan is cached per (scene, size, config); a pure pixel
        permutation."""
        cs = scene.compiled
        scene_cache = self._plan_cache.get(cs)
        if scene_cache is None:
            scene_cache = self._plan_cache.setdefault(cs, {})
        key = (
            "coh", width, height, band_y0, spp,
            self.max_ray_bounce_depth, self.sampler, self.seed,
        )
        entry = scene_cache.get(key)
        if entry is None:
            ys, xs = np.divmod(np.arange(rows_eff * width), width)
            i64 = lambda a: torch.as_tensor(a.astype(np.int64), device=cs.device)
            kind, idx = _first_hit_probe(
                scene, seed, i64(xs), i64(ys + band_y0), width=width,
                height=height, spp=spp, sampler=self.sampler, has_dof=has_dof,
                cam_consts=cam_c,
            )
            kind = kind.cpu().numpy().astype(np.int64)
            idx = idx.cpu().numpy().astype(np.int64)
            hit_key = np.where(kind < 0, -1, (kind << 24) + idx)
            tile = pick_tile(width, band_rows)
            lane_ord = tile_order_lane_index(width, band_rows, tile)[:rows_eff].reshape(-1)
            order = np.lexsort((lane_ord, hit_key))
            while len(scene_cache) >= self._plan_cache_max_configs:
                scene_cache.pop(next(iter(scene_cache)))
            entry = scene_cache[key] = {
                "plan": tuple(
                    torch.as_tensor(np.asarray(a, np.int32), device=cs.device)
                    for a in (xs[order], ys[order] + band_y0, np.zeros(order.size),
                              np.full(order.size, spp))
                )
            }
        px, py, s0, s1 = entry["plan"]
        return _render_band_balanced(
            scene, seed, band_y0, px, py, s0, s1, width=width, height=height,
            band_rows=band_rows, spp=spp, max_depth=self.max_ray_bounce_depth,
            sampler=self.sampler, has_dof=has_dof, cam_consts=cam_c,
        )

    def render(self, scene: Scene, width: int, height: int) -> np.ndarray:
        """Renders and returns the linear-space framebuffer (H, W, 3) f32
        averaged over samples, as numpy."""
        return self.render_device(scene, width, height).cpu().numpy()

    def render_device(self, scene: Scene, width: int, height: int) -> torch.Tensor:
        """Renders on the scene's device; returns the (H, W, 3) f32 tensor."""
        with named_zone("Renderer::render"):
            return self._render_device(scene, width, height)

    def _render_device(self, scene: Scene, width: int, height: int) -> torch.Tensor:
        cs = scene.compiled
        if self.device is not None and torch.empty(0, device=self.device).device != cs.device:
            raise ValueError(
                f"Renderer device {self.device} differs from the scene's {cs.device}"
            )
        spp = self.samples_per_pixel
        if self.sampler == SamplerKind.SOBOL and spp & (spp - 1):
            log.warning(
                "Non power of two samples per pixel will perform poorly "
                "with sobol sampling: %d", spp,
            )
        if width * height * spp >= 2**32:
            raise ValueError(
                f"ray id space {width}x{height}x{spp} exceeds u32; reduce spp"
            )
        has_dof = scene.camera.has_depth_of_field
        s_par, band_rows = self.regen_geometry(width, height, spp)
        n_bands = -(-height // band_rows)
        fb = torch.zeros((n_bands * band_rows, width, 3), dtype=real, device=cs.device)
        cam_c = camera_consts(scene.camera, width, height)
        # s_par = 1: coherence-sorted lanes for tree scenes, cost-sorted
        # lanes for brute scenes; otherwise the plain lane layout
        tree = cs.has_sph_tree or cs.has_quad_tree
        planned = self._render_band_coherent_driver if tree else self._render_band_sorted_driver
        for b in range(n_bands):
            y0 = b * band_rows
            if s_par == 1:
                out = planned(
                    scene, self.seed, y0, min(band_rows, height - y0),
                    band_rows, width, height, spp, has_dof, cam_c,
                )
            else:
                out = _render_band_regen(
                    scene, self.seed, y0, 0, width=width, height=height,
                    band_rows=band_rows, s_par=s_par, spp=spp,
                    sample_limit=spp, max_depth=self.max_ray_bounce_depth,
                    sampler=self.sampler, has_dof=has_dof, cam_consts=cam_c,
                )
            fb[y0 : y0 + band_rows] += out
        return fb[:height] / spp
