"""Render driver (counterpart of ``render/renderer.py``).

Scenes that no render kernel takes (nested checkers: ``ops/bounce.py:
supports_bounce_kernel``) render on the fixed-depth wavefront, as in the
JAX package: row bands times sample chunks (``Renderer.chunk_geometry``),
each chunk one ``_render_band``, one camera ray per (pixel, sample) lane
traced by ``render/integrator.py:trace_paths`` (the closest-hit kernel at
every bounce on the card).  Every other scene renders on the regenerating
path below.

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
    camera ray (``coherent_plan``: on the card one launch makes the keys
    and a device sort orders them, with no host round trip), so the
    threads of a warp start in the same part of the tree;
  * with ``balance_min_spp`` set and reached: a two-pass balanced render,
    an estimation pass whose work counts size a cost-proportional split
    of each pixel's remaining samples over lanes (``build_balance_plan``).

``ZWRT_NO_BALANCE``, ``ZWRT_NO_SORT`` and ``ZWRT_COHERENT=0`` opt out of
the balanced, sorted and coherent plans, read at each render as the JAX
package reads them (without the sorted or coherent plan the plain lane
layout renders).  Every plan runs
the same kernels: ``render_supersampled`` renders a k-times larger image
and box-filters it, ``render/adaptive.py`` and ``render/progressive.py``
hand them per-lane sample windows of their own.

Lane sums are scatter-added into the band.  The content-addressed RNG makes
the image invariant to how samples are assigned to lanes.

Spans (``utils/profiler.py``, recorded only while its recording is on):
``Renderer::render`` around a render (the image's span), ``rayColorLine``
around each band's trace, ``render.plan`` around building a lane plan
with its stages: the coherent plan's ``render.plan.probe`` (its keys:
the camera rays and first-hit probe) and ``render.plan.sort`` (the sort
and the lane tensors), the sorted plan's ``render.plan.fetch`` (the
copies to the host, where the host waits for the card),
``render.plan.sort`` and ``render.plan.upload``; ``render.accumulate``
around summing a band into the framebuffer and averaging it; on image
scenes without a LUT, inside ``rayColorLine``, the bounce kernel's driver
loop (``render/integrator.py:trace_paths_regen``): ``render.regen.launch``
around each regenerating launch's host side, ``render.regen.launch.wait``
inside it around the read of the window ends, and ``render.regen.poll``
around each read of the loop's condition; on the fixed-depth wavefront,
where ``rayColorLine`` is each chunk's ``trace_paths``, inside it
``render.fixed.sync`` around each read of the loop's condition and
``render.fixed.bounce`` around each bounce, with the counters
``fixed.bounces``, ``fixed.lane_slots`` and ``fixed.live_lanes``
(``render/integrator.py:trace_paths``); counters ``plan.hit.<kind>``
and ``plan.miss.<kind>`` of the cost-sorted and coherent plans' cache,
and ``plan.card.coherent`` for each coherent plan built on the card.  The
kernels count their own: K1's ``k1.lane_work``, ``k1.warp_work``,
``k1.block_ns`` and ``k1.slot_ns`` (``ops/fused_render.py``), K2's
``k2.launches``, ``k2.lane_work``, ``k2.warp_work``, ``k2.block_ns`` and
``k2.slot_ns`` (``ops/bounce.py``).
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import os
import weakref
from typing import Optional

import numpy as np
import torch

from ..dtypes import T_MIN, real
from ..ops.bounce import supports_bounce_kernel
from ..ops.closest_hit import closest_hit, coherent_keys
from ..ops.fused_render import THREADS
from ..sampling.sampler import SamplerKind
from ..scene import Scene
from ..utils.profiler import count, named_zone
from .camera import camera_consts, camera_params, camera_params_from_consts, generate_rays
from .integrator import trace_paths, trace_paths_regen

log = logging.getLogger("zwrt")

TILE = 32  # pixel-block side for tiled lane order
PROBE_T_MIN = float(np.float32(1e-4))  # the first-hit probe's t_min


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


def tile_order_lane_index(width, band_rows, tile, device=None):
    """(band_rows, width) int64 of each pixel's lane index in the tiled
    ray_grid order (s_par = 1), accounting for tile padding: a NumPy array,
    or with ``device`` a tensor made there (no copy from the host)."""
    if device is None:
        y, x = np.arange(band_rows)[:, None], np.arange(width)[None, :]
    else:
        y = torch.arange(band_rows, device=device)[:, None]
        x = torch.arange(width, device=device)[None, :]
    if tile is None:
        return y * width + x
    nbx = -(-width // tile)
    by, iy = y // tile, y % tile
    bx, ix = x // tile, x % tile
    return (((by * nbx + bx) * tile + iy) * tile) + ix


@functools.lru_cache(maxsize=8)
def _lane_index_on(device: torch.device, width: int, rows: int, tile) -> torch.Tensor:
    """``tile_order_lane_index`` flat on ``device``, made once per shape."""
    return tile_order_lane_index(width, rows, tile, device).reshape(-1)


def memo_plan_entry(cache, compiled, key, max_configs: int,
                    kind: Optional[str] = None) -> dict:
    """The entry of ``key`` among ``compiled``'s plans in ``cache`` (a weak
    map from compiled scene to a {config: entry} dict, so that entries die
    with their scene), made empty when missing; a scene keeps at most
    ``max_configs`` entries, the oldest evicted first.  With ``kind`` it
    counts ``plan.hit.<kind>`` or ``plan.miss.<kind>``."""
    per = cache.get(compiled)
    if per is None:
        per = cache.setdefault(compiled, {})
    entry = per.get(key)
    if kind is not None:
        count(f"plan.{'miss' if entry is None else 'hit'}.{kind}")
    if entry is None:
        while len(per) >= max_configs:
            per.pop(next(iter(per)))
        entry = per[key] = {}
    return entry


def sorted_plan(work_lane: np.ndarray, width, band_rows, rows_eff, band_y0, n_items):
    """(px, py, live) int32 arrays of one band's cost-sorted plan: its
    pixels in descending order of the work measured by their lanes
    (``work_lane`` in tiled lane order, s_par = 1; a stable sort, ties in
    image order), padded to ``n_items`` with dead items (live 0, pixel
    (0, band_y0)), to which the caller gives an empty sample range."""
    lane_idx = tile_order_lane_index(width, band_rows, pick_tile(width, band_rows))
    cost = work_lane[lane_idx.reshape(-1)].reshape(band_rows, width)[:max(rows_eff, 0)]
    cost = cost.reshape(-1)
    ys, xs = np.divmod(np.arange(cost.size), width)
    order = np.argsort(-cost, kind="stable")
    pad = n_items - cost.size
    px = np.concatenate([xs[order], np.zeros(pad, np.int64)])
    py = np.concatenate([ys[order] + band_y0, np.full(pad, band_y0, np.int64)])
    live = np.concatenate([np.ones(cost.size, np.int64), np.zeros(pad, np.int64)])
    return tuple(a.astype(np.int32) for a in (px, py, live))


def _render_band(
    scene: Scene, seed: int, band_y0: int, sample0: int, *, width: int, height: int,
    band_rows: int, spp_chunk: int, spp: int, max_depth: int, sampler: SamplerKind,
    has_dof: bool, sample_limit: Optional[int] = None, rr: int = 0, clamp: float = 0.0,
) -> torch.Tensor:
    """One (row band x sample chunk) of the fixed-depth wavefront: the
    camera rays of samples [sample0, sample0 + spp_chunk) of the band's
    pixels, traced by ``trace_paths`` with Russian roulette from bounce
    ``rr`` and the indirect ``clamp`` (its gate: off on image scenes).
    ``spp`` is the render's total (the samplers' geometry); sample indices
    at or past ``sample_limit`` (default ``spp``) count nothing.  Returns
    the (band_rows, width, 3) radiance sum over the chunk."""
    cs = scene.compiled
    tile = pick_tile(width, band_rows)
    px, py, sidx, ray_id = ray_grid(
        width, height, band_y0, band_rows, sample0, spp_chunk, tile, device=cs.device
    )
    origin, direction, time = generate_rays(
        camera_params(scene.camera, width, height), has_dof, sampler, seed, ray_id, px, py,
        sidx, spp, width, height,
    )
    with named_zone("rayColorLine"):
        radiance = trace_paths(cs, origin, direction, time, seed, ray_id, max_depth,
                               rr_start=rr, clamp=clamp)
    valid = sidx < (spp if sample_limit is None else sample_limit)
    rad = radiance.to_array() * valid[:, None]
    return unflatten_radiance(rad, width, band_rows, spp_chunk, tile).sum(dim=0)


def _render_band_regen(
    scene: Scene, seed: int, band_y0: int, sample0: int, *,
    width: int, height: int, band_rows: int, s_par: int, spp: int,
    sample_limit: int, max_depth: int, sampler: SamplerKind, has_dof: bool,
    cam_consts, want_work: bool = False, rr: int = 0, clamp: float = 0.0,
):
    """Regenerating band render: each of band_rows * width * s_par lanes
    traces its pixel's samples {sample0 + k + j * s_par} < sample_limit,
    with Russian roulette from bounce ``rr`` and the indirect ``clamp``
    (0: off).  ``spp`` is the render's total (the samplers' geometry).
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
            rr_start=rr, clamp=clamp,
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
    hit = closest_hit(cs, origin, direction, time, PROBE_T_MIN)
    return hit.kind, hit.idx


def coherent_plan_keys(
    scene: Scene, seed: int, band_y0: int, rows: int, tile, *, width: int, height: int,
    spp: int, sampler: SamplerKind, has_dof: bool, cam_consts,
) -> torch.Tensor:
    """(rows * width,) int64 sort keys of the coherent plan, in row order:
    ((hit_key + 1) << 32) | lane for each pixel of rows [band_y0, band_y0 +
    rows), hit_key = (kind << 24) + idx of its sample-0 ray's first hit (-1
    on a miss), lane its index in the band's lane order with ``tile``
    (``tile_order_lane_index``).  The keys are unique, so sorting them is a
    lexsort of (lane, hit_key).  On the card one launch of
    ``ops/closest_hit.py:coherent_keys`` makes the camera rays and the high
    word; on the CPU its plain version, the eager ``_first_hit_probe``."""
    cs = scene.compiled
    if cs.device.type == "cuda":
        high = coherent_keys(cs, seed, band_y0, rows, PROBE_T_MIN, camera_consts=cam_consts,
                             sampler=sampler, width=width, height=height, spp=spp,
                             has_dof=has_dof)
    else:
        pix = torch.arange(rows * width, dtype=torch.int64, device=cs.device)
        kind, idx = _first_hit_probe(
            scene, seed, pix % width, pix // width + band_y0, width=width, height=height,
            spp=spp, sampler=sampler, has_dof=has_dof, cam_consts=cam_consts,
        )
        high = (torch.where(kind < 0, -1, (kind.to(torch.int64) << 24) + idx) + 1) << 32
    return high | _lane_index_on(cs.device, width, rows, tile)


def coherent_plan(
    scene: Scene, seed: int, band_y0: int, rows_eff: int, band_rows: int, *, width: int,
    height: int, spp: int, sampler: SamplerKind, has_dof: bool, cam_consts,
):
    """(px, py, s0, s1), (rows_eff * width,) int32 on the scene's device:
    one band's coherent plan, its pixels in the order of their
    ``coherent_plan_keys``, each lane a pixel's whole sample range [0,
    spp).  On the card the keys and their sort stay there: nothing waits
    for it."""
    with named_zone("render.plan.probe"):
        keys = coherent_plan_keys(scene, seed, band_y0, rows_eff, pick_tile(width, band_rows),
                                  width=width, height=height, spp=spp, sampler=sampler,
                                  has_dof=has_dof, cam_consts=cam_consts)
        if keys.device.type == "cuda":
            count("plan.card.coherent")
    with named_zone("render.plan.sort"):
        order = torch.argsort(keys)
        px = (order % width).to(torch.int32)
        py = (order // width + band_y0).to(torch.int32)
        return px, py, torch.zeros_like(px), torch.full_like(px, spp)


def _render_band_balanced(
    scene: Scene, seed: int, band_y0: int, px, py, s0, s1, *,
    width: int, height: int, band_rows: int, spp: int, max_depth: int,
    sampler: SamplerKind, has_dof: bool, cam_consts, rr: int = 0, clamp: float = 0.0,
):
    """Plan render: lanes carry explicit (pixel, sample-range) work items
    ((M,) int32 on the scene's device; s1 <= s0: a dead lane); per-lane
    radiance sums are scatter-added into the band framebuffer.  Each
    (pixel, sample) pair belongs to one lane, so the sum is the same
    whatever the lane order."""
    cs = scene.compiled
    with named_zone("rayColorLine"):
        radiance = trace_paths_regen(
            cs, cam_consts, seed, px, py, s0, s1, sampler=sampler, width=width,
            height=height, spp=spp, stride=1, max_depth=max_depth,
            has_dof=has_dof, rr_start=rr, clamp=clamp,
        )
    pixflat = ((py - band_y0) * width + px).to(torch.int64)
    fb = torch.zeros((band_rows * width, 3), dtype=real, device=cs.device)
    fb.index_add_(0, pixflat, radiance.to_array())
    return fb.reshape(band_rows, width, 3)


def balance_lane_budget(band_rows: int, width: int, overprovision: float,
                        blk: int = THREADS) -> int:
    """Lanes of a balanced band: ``overprovision`` times its pixels,
    rounded up to a multiple of ``blk`` (the render kernel's block; the
    JAX package's is its wavefront block, rows * 128)."""
    budget = int(overprovision * band_rows * width)
    return -(-budget // blk) * blk


def build_balance_plan(work_px: np.ndarray, band_y0: int, spp_est: int, spp: int,
                       budget_lanes: int, tile):
    """Profile-guided lane plan (the JAX package's, lane for lane): each
    pixel's remaining samples [spp_est, spp) split over about
    cost-proportional lane counts, so that every lane carries about equal
    predicted work (cost x samples).  ``work_px`` (rows, width) is each
    pixel's cost from the estimation pass.  Pixels in tile order, a pixel's
    lanes adjacent.  Returns (px, py, s0, s1) int32 arrays of
    ``budget_lanes``; surplus lanes are dead (s1 == s0 == 0)."""
    rows, width = work_px.shape
    lane_idx = tile_order_lane_index(width, rows, tile).reshape(-1)
    order = np.argsort(lane_idx, kind="stable")

    cost = np.maximum(work_px.reshape(-1).astype(np.float64), 1.0)[order]
    ys = (np.repeat(np.arange(rows), width) + band_y0)[order]
    xs = np.tile(np.arange(width), rows)[order]

    n_pix = cost.size
    r = spp - spp_est
    extra = max(0, budget_lanes - n_pix)
    share = extra * cost / cost.sum()
    k = 1 + np.floor(share).astype(np.int64)
    rem = budget_lanes - int(k.sum())
    if rem > 0:
        frac_order = np.argsort(-(share - np.floor(share)), kind="stable")
        k[frac_order[:rem]] += 1
    k = np.minimum(k, max(r, 1))  # never more lanes than samples

    total = int(k.sum())
    px = np.repeat(xs, k)
    py = np.repeat(ys, k)
    starts = np.cumsum(k) - k
    j = np.arange(total) - np.repeat(starts, k)
    kk = np.repeat(k, k)
    s0 = spp_est + (j * r) // kk
    s1 = spp_est + ((j + 1) * r) // kk

    pad = budget_lanes - total
    if pad:
        px = np.concatenate([px, np.zeros(pad, np.int64)])
        py = np.concatenate([py, np.full(pad, band_y0, np.int64)])
        s0 = np.concatenate([s0, np.zeros(pad, np.int64)])
        s1 = np.concatenate([s1, np.zeros(pad, np.int64)])
    return tuple(a.astype(np.int32) for a in (px, py, s0, s1))


# The fixed-depth wavefront's lanes in flight a chunk, the default of every
# render that takes the option (``Renderer``, ``parallel/render.py``,
# ``render/aov.py``).  The JAX package's 1 << 21 fits a TPU chip; on the
# H100 a chunk that size leaves the card waiting on the host's eager
# enqueue of each bounce's shading.  A chunk holds about 1.3 KB a lane of
# state and shading temporaries on its device.
MAX_RAYS_PER_CHUNK = 1 << 24


@dataclasses.dataclass
class Renderer:
    """User-facing render configuration; field names and defaults are the
    JAX package's but ``max_rays_per_chunk``'s (``MAX_RAYS_PER_CHUNK``).  ``device`` (default: the
    scene's) must match the scene's device; a CUDA device without a GPU
    raises."""

    samples_per_pixel: int = 10
    max_ray_bounce_depth: int = 20
    sampler: SamplerKind = SamplerKind.SOBOL
    seed: int = 0
    # Max rays in flight per band (a chunk of the fixed-depth wavefront).
    max_rays_per_chunk: int = MAX_RAYS_PER_CHUNK
    # Unused by the port (it has no XLA BVH path); kept for field parity.
    max_rays_per_chunk_bvh: int = 1 << 17
    # Russian roulette from this bounce index (0 = off, the reference's
    # semantics): from bounce d >= russian_roulette a path goes on with
    # p = clamp(max(throughput), RR_P_MIN, 1) and carries 1 / p.  Ignored
    # on image scenes without a texture LUT (render/integrator.py).
    russian_roulette: int = 0
    # The indirect luminance clamp (0 = off): a contribution landed at
    # bounce >= 1 is scaled to at most this luminance.  The same gate.
    clamp_indirect: float = 0.0
    # Minimum lanes in flight; beyond it fewer samples per pixel run in
    # parallel (s_par), each lane walking its pixel's samples in sequence.
    regen_min_wave: int = 1 << 17
    # Two-pass profile-guided balancing from this spp on (0 = off): an
    # estimation pass (spp / 16 samples, which count in the image) measures
    # each pixel's cost, then the rest of its samples are split over about
    # cost-proportional lane counts, balance_overprovision times the
    # pixels in all.  ZWRT_NO_BALANCE=1 turns it off.
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
        if self.device is not None:
            dev = torch.device(self.device)
            if dev.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError(
                    f"Renderer(device={self.device!r}): CUDA is not available"
                )

    def chunk_geometry(self, scene: Scene, width: int, height: int, spp_req: int):
        """(spp_chunk, band_rows) of the fixed-depth wavefront: as many
        samples per chunk as ``max_rays_per_chunk`` lanes hold, then rows
        split if one sample of the image is still larger.  The JAX package
        caps scenes on its XLA BVH at ``max_rays_per_chunk_bvh``; the port
        has no XLA BVH, so that cap stays unused."""
        spp_chunk = max(1, min(spp_req, self.max_rays_per_chunk // max(width * height, 1)))
        band_rows = max(1, min(height, self.max_rays_per_chunk // (width * spp_chunk)))
        return spp_chunk, band_rows

    def regen_geometry(self, width: int, height: int, spp: int):
        """(s_par, band_rows): just enough samples in flight per pixel to
        reach regen_min_wave lanes, rows capped by max_rays_per_chunk."""
        pixels = max(width * height, 1)
        s_par = max(1, min(spp, -(-self.regen_min_wave // pixels)))
        band_rows = max(1, min(height, self.max_rays_per_chunk // (width * s_par)))
        return s_par, band_rows

    def _estimator(self) -> dict:
        """The estimator options as the band renders take them."""
        return {"rr": self.russian_roulette, "clamp": self.clamp_indirect}

    def _render_band_balanced_driver(
        self, scene: Scene, seed: int, band_y0: int, rows_eff: int,
        band_rows: int, width: int, height: int, spp: int, has_dof, cam_c,
    ):
        """Two-pass balanced band render: the estimation pass renders each
        pixel's first spp_est samples (they count in the image) and
        measures its cost; the balanced plan renders the rest."""
        # clamped to spp: with spp <= 2 the estimation pass is the render
        spp_est = min(spp, max(2, spp // 16))
        tile = pick_tile(width, band_rows)
        fb_est, work = _render_band_regen(
            scene, seed, band_y0, 0, width=width, height=height,
            band_rows=band_rows, s_par=1, spp=spp, sample_limit=spp_est,
            max_depth=self.max_ray_bounce_depth, sampler=self.sampler,
            has_dof=has_dof, cam_consts=cam_c, want_work=True, **self._estimator(),
        )
        lane_idx = tile_order_lane_index(width, band_rows, tile)
        work_px = work.cpu().numpy()[lane_idx.reshape(-1)].reshape(band_rows, width)[:rows_eff]
        budget = balance_lane_budget(band_rows, width, self.balance_overprovision)
        plan = build_balance_plan(work_px, band_y0, spp_est, spp, budget, tile)
        px, py, s0, s1 = (torch.as_tensor(a, device=scene.compiled.device) for a in plan)
        out = _render_band_balanced(
            scene, seed, band_y0, px, py, s0, s1, width=width, height=height,
            band_rows=band_rows, spp=spp, max_depth=self.max_ray_bounce_depth,
            sampler=self.sampler, has_dof=has_dof, cam_consts=cam_c, **self._estimator(),
        )
        return fb_est + out

    def _render_band_sorted_driver(
        self, scene: Scene, seed: int, band_y0: int, rows_eff: int,
        band_rows: int, width: int, height: int, spp: int, has_dof, cam_c,
    ):
        """Cost-sorted lanes with temporal reuse: the first render of this
        (scene, size, config) runs the plain lane layout with the work count
        as a side output and caches it; later renders sort pixels by that
        cost (a pure pixel permutation)."""
        cs = scene.compiled
        key = (
            width, height, band_y0, spp,
            self.max_ray_bounce_depth, self.sampler, self.seed,
        )
        entry = memo_plan_entry(self._plan_cache, cs, key, self._plan_cache_max_configs,
                                "sorted")
        if not entry:
            fb, work = _render_band_regen(
                scene, seed, band_y0, 0, width=width, height=height,
                band_rows=band_rows, s_par=1, spp=spp, sample_limit=spp,
                max_depth=self.max_ray_bounce_depth, sampler=self.sampler,
                has_dof=has_dof, cam_consts=cam_c, want_work=True, **self._estimator(),
            )
            entry["work"] = work
            return fb
        if "plan" not in entry:
            with named_zone("render.plan"):
                with named_zone("render.plan.fetch"):
                    work = entry.pop("work").cpu().numpy()
                with named_zone("render.plan.sort"):
                    px, py, live = sorted_plan(work, width, band_rows, rows_eff, band_y0,
                                               rows_eff * width)
                with named_zone("render.plan.upload"):
                    entry["plan"] = tuple(
                        torch.as_tensor(a, device=cs.device)
                        for a in (px, py, np.zeros_like(live), live * np.int32(spp))
                    )
        px, py, s0, s1 = entry["plan"]
        return _render_band_balanced(
            scene, seed, band_y0, px, py, s0, s1, width=width, height=height,
            band_rows=band_rows, spp=spp, max_depth=self.max_ray_bounce_depth,
            sampler=self.sampler, has_dof=has_dof, cam_consts=cam_c, **self._estimator(),
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
        key = (
            "coh", width, height, band_y0, spp,
            self.max_ray_bounce_depth, self.sampler, self.seed,
        )
        entry = memo_plan_entry(self._plan_cache, cs, key, self._plan_cache_max_configs,
                                "coherent")
        if "plan" not in entry:
            with named_zone("render.plan"):
                entry["plan"] = coherent_plan(
                    scene, seed, band_y0, rows_eff, band_rows, width=width, height=height,
                    spp=spp, sampler=self.sampler, has_dof=has_dof, cam_consts=cam_c,
                )
        px, py, s0, s1 = entry["plan"]
        return _render_band_balanced(
            scene, seed, band_y0, px, py, s0, s1, width=width, height=height,
            band_rows=band_rows, spp=spp, max_depth=self.max_ray_bounce_depth,
            sampler=self.sampler, has_dof=has_dof, cam_consts=cam_c, **self._estimator(),
        )

    def _plan_kind(self, cs, s_par: int) -> Optional[str]:
        """The lane plan of a regenerating render at ``s_par``: with one
        sample in flight per pixel the balanced plan when asked for, else
        coherence-sorted lanes for tree scenes and cost-sorted lanes for
        brute scenes, unless opted out; otherwise None, the plain lane
        layout."""
        if s_par != 1:
            return None
        if (self.balance_min_spp > 0 and self.samples_per_pixel >= self.balance_min_spp
                and not os.environ.get("ZWRT_NO_BALANCE")):
            return "balanced"
        if cs.has_sph_tree or cs.has_quad_tree:
            return "coherent" if os.environ.get("ZWRT_COHERENT", "1") not in ("", "0") else None
        return None if os.environ.get("ZWRT_NO_SORT") else "sorted"

    def render_lanes(self, scene: Scene, width: int, height: int):
        """(px, py, s0, s1, stride) of the lanes that ``render_device``
        hands the render kernel for ``scene`` at ``width`` x ``height``:
        its cached cost-sorted or coherent plan (after the renders that
        build it: two for a cost-sorted plan, one for a coherent plan),
        else the plain lane layout.  Lane tensors are (N,) int32 on the
        scene's device.  Raises for a render of more than one band, the
        balanced driver (its plan is not kept), a plan not built yet, or a
        scene that no render kernel takes."""
        cs = scene.compiled
        if not supports_bounce_kernel(cs):
            raise ValueError("nested checkers render on the fixed-depth wavefront, which "
                             "has no render-kernel lanes")
        spp = self.samples_per_pixel
        s_par, band_rows = self.regen_geometry(width, height, spp)
        if band_rows < height:
            raise ValueError(f"{width}x{height}@{spp} renders in more than one band")
        kind = self._plan_kind(cs, s_par)
        if kind == "balanced":
            raise ValueError("the balanced driver keeps no lane plan")
        if kind is None:
            px, py, sidx, _ = ray_grid(width, height, 0, band_rows, 0, s_par,
                                       pick_tile(width, band_rows), device=cs.device)
            i32 = lambda a: a.to(torch.int32).contiguous()
            return i32(px), i32(py), i32(sidx), i32(torch.full_like(px, spp)), s_par
        key = (width, height, 0, spp, self.max_ray_bounce_depth, self.sampler, self.seed)
        if kind == "coherent":
            key = ("coh", *key)
        entry = self._plan_cache.get(cs, {}).get(key, {})
        if "plan" not in entry:
            raise ValueError(f"no {kind} plan of {width}x{height}@{spp} is cached yet: "
                             "render first")
        return (*entry["plan"], 1)

    def kernel_call(self, scene: Scene, width: int, height: int):
        """A call that runs the scene's render kernel once over
        ``render_lanes`` and returns (radiance V3, work) per lane: the
        fused render kernel (``ops/fused_render.py``) where it takes the
        scene, else the bounce kernel's regenerating mode
        (``ops/bounce.py``) from fresh lanes, which drains every window in
        one launch; the walk is the one the environment names at the call.
        On CPU tensors each runs its plain version."""
        from ..ops.bounce import bounce_regen, supports_fused_render
        from ..ops.fused_render import render_fused
        from .integrator import initial_regen_state

        cs = scene.compiled
        px, py, s0, s1, stride = self.render_lanes(scene, width, height)
        kw = dict(camera_consts=camera_consts(scene.camera, width, height), sampler=self.sampler,
                  width=width, height=height, spp=self.samples_per_pixel, stride=stride,
                  max_depth=self.max_ray_bounce_depth,
                  has_dof=scene.camera.has_depth_of_field,
                  rr_start=self.russian_roulette, clamp=self.clamp_indirect)
        if supports_fused_render(cs):
            return lambda: render_fused(cs, px, py, s0, s1, self.seed, T_MIN, want_work=True,
                                        **kw)
        st0 = initial_regen_state(s0, stride)

        def run():
            st = bounce_regen(cs, st0, px, py, s1, self.seed, T_MIN, **kw)
            return st.radiance, st.work

        return run

    def render_supersampled(self, scene: Scene, width: int, height: int,
                            k: int = 2) -> torch.Tensor:
        """Renders at (k * width, k * height) with spp / k^2 samples per
        subpixel and box-filters to (height, width, 3) on the device: each
        pixel still averages ``samples_per_pixel`` rays over its area, the
        k^2 subpixels stratifying it (not bitwise ``render``: other sample
        positions)."""
        if k < 1:
            raise ValueError(f"supersample factor must be >= 1, got {k}")
        if k == 1:
            return self.render_device(scene, width, height)
        spp = self.samples_per_pixel
        if spp % (k * k):
            raise ValueError(
                f"samples_per_pixel={spp} must be divisible by k^2={k * k} "
                "for supersampled rendering (each subpixel renders "
                "spp/k^2 samples)"
            )
        sub = dataclasses.replace(self, samples_per_pixel=spp // (k * k))
        if self.sampler == SamplerKind.SOBOL:
            # Sobol's pixel offsets lie in [0, 1) from pixel00 (the
            # reference's raster convention), an anchor of half a pixel
            # that scales with the resolution: shift the k-times grid by
            # (k - 1) / 2 subpixels so that the k^2 subpixels tile each
            # pixel's own area
            s = (k - 1) / 2.0
            shift = scene.camera.raster_shift
            scene = dataclasses.replace(scene, camera=dataclasses.replace(
                scene.camera, raster_shift=(shift[0] + s, shift[1] + s)))
        fb = sub.render_device(scene, width * k, height * k)
        return fb.reshape(height, k, width, k, 3).mean(dim=(1, 3))

    def render_adaptive(self, scene: Scene, width: int, height: int, *,
                        pilot_spp: int = 0, return_stats: bool = False):
        """Variance-guided adaptive render at the same total sample budget
        as ``render`` (render/adaptive.py); the averaged (H, W, 3) tensor
        on the scene's device, plus a stats dict with ``return_stats``."""
        from .adaptive import render_adaptive

        return render_adaptive(self, scene, width, height, pilot_spp=pilot_spp,
                               return_stats=return_stats)

    def render(self, scene: Scene, width: int, height: int) -> np.ndarray:
        """Renders and returns the linear-space framebuffer (H, W, 3) f32
        averaged over samples, as numpy."""
        return self.render_device(scene, width, height).cpu().numpy()

    def render_device(self, scene: Scene, width: int, height: int) -> torch.Tensor:
        """Renders on the scene's device; returns the (H, W, 3) f32 tensor."""
        with named_zone("Renderer::render", image=True):
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
        if not supports_bounce_kernel(cs):
            return self._render_fixed_depth(scene, width, height)
        s_par, band_rows = self.regen_geometry(width, height, spp)
        n_bands = -(-height // band_rows)
        fb = torch.zeros((n_bands * band_rows, width, 3), dtype=real, device=cs.device)
        cam_c = camera_consts(scene.camera, width, height)
        planned = {
            "balanced": self._render_band_balanced_driver,
            "coherent": self._render_band_coherent_driver,
            "sorted": self._render_band_sorted_driver,
        }.get(self._plan_kind(cs, s_par))
        for b in range(n_bands):
            y0 = b * band_rows
            if planned is not None:
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
                    **self._estimator(),
                )
            with named_zone("render.accumulate"):
                fb[y0 : y0 + band_rows] += out
        with named_zone("render.accumulate"):
            return fb[:height] / spp

    def _render_fixed_depth(self, scene: Scene, width: int, height: int) -> torch.Tensor:
        """The fixed-depth wavefront of the whole image, averaged."""
        spp = self.samples_per_pixel
        return self._fixed_depth_fb(scene, 0, height, 0, spp, spp, width, height)[:height] / spp

    def _fixed_depth_fb(self, scene: Scene, y0: int, rows: int, sample0: int, n_samples: int,
                        sample_limit: int, width: int, height: int) -> torch.Tensor:
        """The radiance-sum framebuffer of rows [y0, y0 + rows) over samples
        [sample0, sample0 + n_samples) of the fixed-depth wavefront: bands x
        chunks of ``_render_band``, sample indices at or past
        ``sample_limit`` counting nothing.  (n_bands * band_rows, width, 3)
        on the scene's device, its padded rows included."""
        spp_chunk, band_rows = self.chunk_geometry(scene, width, rows, n_samples)
        n_bands = -(-rows // band_rows)
        fb = torch.zeros((n_bands * band_rows, width, 3), dtype=real,
                         device=scene.compiled.device)
        for b in range(n_bands):
            for c in range(-(-n_samples // spp_chunk)):
                fb[b * band_rows : (b + 1) * band_rows] += _render_band(
                    scene, self.seed, y0 + b * band_rows, sample0 + c * spp_chunk,
                    width=width, height=height, band_rows=band_rows, spp_chunk=spp_chunk,
                    spp=self.samples_per_pixel, max_depth=self.max_ray_bounce_depth,
                    sampler=self.sampler, has_dof=scene.camera.has_depth_of_field,
                    sample_limit=sample_limit, **self._estimator(),
                )
        return fb
