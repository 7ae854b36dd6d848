"""Variance-guided adaptive sampling (counterpart of ``render/adaptive.py``).

The total sample budget is the uniform render's (samples_per_pixel times
the pixels), re-allocated per pixel by measured noise: a pilot pass, whose
samples count in the image, renders as two halves; their per-pixel
difference estimates each pixel's Monte-Carlo noise, and the rest of the
budget goes out about in proportion (samples ~ sigma), half of it to every
pixel unconditionally.  Each pixel averages its own sample count, so the
estimator stays unbiased.

The extra samples render as a lane plan of (pixel, sample-window) items
through the same kernels as every other plan (``renderer.
_render_band_balanced``: the render kernel, or the bounce kernel's
regenerating mode on atlas scenes); a pixel's windows reach sample indices
past spp, which the kernels' Sobol tables cover (``ops/fused_render.py:
launch_windows``).  The plan is built on the scene's device
(``render/adaptive_device.py``) unless ``ZWRT_ADAPTIVE_HOST=1`` asks for
the host functions of this module, which are its plain versions.

Samplers: Sobol and independent; the stratified sampler's strata are fixed
by spp, so it raises.  Ray ids are sample-major ((sample * H + py) * W +
px), so a pixel's indices past spp never meet another pixel's stream; the
u32 bound is checked against the largest index a pixel may reach.

Scenes with nested checkers take no regenerating kernel: as in the JAX
package, the adaptive render logs ``ADAPTIVE_UNIFORM`` and renders
uniformly at spp (the fixed-depth wavefront), its count map uniform.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from ..dtypes import LUM_B, LUM_G, LUM_R, real
from ..ops.fused_render import THREADS

log = logging.getLogger("zwrt")
# logged when a scene takes no regenerating kernel (nested checkers): the
# render is the uniform one, as in the JAX package
ADAPTIVE_UNIFORM = ("adaptive sampling needs the regenerating render path, which nested "
                    "checkers leave; rendering uniformly at %d spp")

# Half-width of the box that smooths the noise map: one pixel's
# half-difference is chi-distributed (a lucky agreement reads as no noise),
# so a 3x3 average borrows from the neighbours.
_SMOOTH = 1
# Fraction of the mean weight added to every pixel, so that black and
# lucky-zero pixels still converge.
_WEIGHT_FLOOR = 0.05
# Fraction of the post-pilot budget that every pixel keeps; only the rest
# follows the noise map.
_RESERVE = 0.5


def variance_weights(half_a: np.ndarray, half_b: np.ndarray) -> np.ndarray:
    """Per-pixel noise proxy from the two half-pilot means, (rows, W, 3)
    each: the luminance of |mean_A - mean_B|, 3x3 box-smoothed with edge
    padding.  Returns (rows, W) float64 >= 0."""
    d = np.abs(half_a.astype(np.float64) - half_b.astype(np.float64))
    lum = float(LUM_R) * d[..., 0] + float(LUM_G) * d[..., 1] + float(LUM_B) * d[..., 2]
    p = np.pad(lum, _SMOOTH, mode="edge")
    rows, width = lum.shape
    k = 2 * _SMOOTH + 1
    sm = np.zeros_like(lum)
    for i in range(k):
        for j in range(k):
            sm += p[i : i + rows, j : j + width]
    return sm / (k * k)


def allocate_extra(weight: np.ndarray, extra_total: int, cap: int) -> np.ndarray:
    """Apportions ``extra_total`` samples over the pixels in proportion to
    ``weight`` (rows, W), each pixel capped at ``cap``; largest-remainder
    rounding keeps the total exactly (unless the cap binds everywhere).
    Returns (rows, W) int64 >= 0."""
    w = weight.reshape(-1).astype(np.float64)
    w = w + max(float(w.mean()), 1e-300) * _WEIGHT_FLOOR
    n = np.zeros(w.size, np.int64)
    remaining = int(extra_total)
    # hand out again what the cap clipped: each pass uses up the budget or
    # fills at least one pixel
    for _ in range(32):
        room = cap - n
        open_w = np.where(room > 0, w, 0.0)
        tot = open_w.sum()
        if remaining <= 0 or tot <= 0.0:
            break
        share = remaining * open_w / tot
        add = np.minimum(np.floor(share).astype(np.int64), room)
        if add.sum() == 0:
            # the tail: single samples by largest remainder
            frac = np.where(room > 0, share, -1.0)
            order = np.argsort(-frac, kind="stable")[:remaining]
            take = order[room[order] > 0]
            n[take] += 1
            remaining -= take.size
            break
        n += add
        remaining -= int(add.sum())
    return n.reshape(weight.shape)


def build_adaptive_plan(n_extra: np.ndarray, band_y0: int, pilot: int, tile, lane_cap: int,
                        sort_lanes: bool = False, blk: int = THREADS):
    """Lane plan of the extra pass: pixel (y, x) renders samples [pilot,
    pilot + n_extra) in ceil(n / lane_cap) lanes of at most lane_cap
    samples, pixels in tile order, none for n == 0.  With ``sort_lanes``
    the lanes are ordered by descending window length (stable), so that a
    warp's lanes carry similar work; tree scenes keep the tile order, the
    coherent one.  Returns (px, py, s0, s1) int32, padded with dead lanes
    (s1 == s0 == 0) to a power of two of at least ``blk`` (the render
    kernel's block; the JAX package's is rows * 128)."""
    from .renderer import tile_order_lane_index

    rows, width = n_extra.shape
    lane_idx = tile_order_lane_index(width, rows, tile).reshape(-1)
    order = np.argsort(lane_idx, kind="stable")

    n = n_extra.reshape(-1).astype(np.int64)[order]
    ys = (np.repeat(np.arange(rows), width) + band_y0)[order]
    xs = np.tile(np.arange(width), rows)[order]

    live = n > 0
    n, ys, xs = n[live], ys[live], xs[live]
    k = -(-n // lane_cap)  # lanes per pixel
    total = int(k.sum())

    px = np.repeat(xs, k)
    py = np.repeat(ys, k)
    starts = np.cumsum(k) - k
    j = np.arange(total) - np.repeat(starts, k)
    nn = np.repeat(n, k)
    kk = np.repeat(k, k)
    s0 = pilot + (j * nn) // kk
    s1 = pilot + ((j + 1) * nn) // kk

    if sort_lanes and total:
        by_len = np.argsort(-(s1 - s0), kind="stable")
        px, py, s0, s1 = px[by_len], py[by_len], s0[by_len], s1[by_len]

    n_pad = max(blk, -(-max(total, 1) // blk) * blk)
    n_pad = 1 << int(n_pad - 1).bit_length()
    pad = n_pad - total
    if pad:
        px = np.concatenate([px, np.zeros(pad, np.int64)])
        py = np.concatenate([py, np.full(pad, band_y0, np.int64)])
        s0 = np.concatenate([s0, np.zeros(pad, np.int64)])
        s1 = np.concatenate([s1, np.zeros(pad, np.int64)])
    return tuple(a.astype(np.int32) for a in (px, py, s0, s1))


def pick_pilot(spp: int) -> int:
    """The default pilot: the largest power of two <= max(4, spp / 8),
    clamped to spp / 2."""
    target = max(4, spp // 8)
    pilot = 1 << (int(target).bit_length() - 1)
    return max(2, min(pilot, spp // 2))


def render_adaptive(renderer, scene, width: int, height: int, *, pilot_spp: int = 0,
                    return_stats: bool = False):
    """Adaptive render at the renderer's ``samples_per_pixel`` budget: the
    image's sample count is the uniform render's, each pixel's in
    proportion to its measured noise.  Returns the averaged (H, W, 3)
    float32 tensor on the scene's device (and with ``return_stats`` a dict:
    ``n_samples``, the (H, W) int64 count map, and ``pilot``)."""
    from ..ops.bounce import supports_bounce_kernel
    from ..sampling.sampler import SamplerKind
    from .adaptive_device import plan_pipeline, plan_lane_budget, reserve_base
    from .camera import camera_consts
    from .renderer import _render_band_balanced, _render_band_regen, pick_tile
    from .renderer import tile_order_lane_index

    spp = renderer.samples_per_pixel
    if renderer.sampler == SamplerKind.STRATIFIED:
        raise ValueError(
            "adaptive sampling needs per-pixel sample counts; the "
            "stratified sampler's grid is fixed by spp — use sobol or "
            "independent"
        )
    pilot = pilot_spp or pick_pilot(spp)
    pilot = max(2, min(pilot, spp))
    pilot += pilot & 1  # two equal halves
    if not supports_bounce_kernel(scene.compiled):
        log.warning(ADAPTIVE_UNIFORM, spp)
        pilot = spp
    if pilot >= spp:
        fb = renderer.render_device(scene, width, height)
        if return_stats:
            return fb, {"n_samples": np.full((height, width), spp, np.int64)}
        return fb

    # the per-pixel cap keeps the sample-major u32 ray ids valid and bounds
    # the concentration at 64 times the mean extra budget
    cap = min(64 * (spp - pilot), (2**32) // (width * height) - pilot - 1)
    if cap < 1:
        raise ValueError(
            f"ray id space {width}x{height}x{spp} leaves no adaptive "
            "headroom; reduce spp or the image size"
        )
    lane_cap = max(8, 2 * (spp - pilot))

    cs = scene.compiled
    band_rows = max(1, min(height, renderer.max_rays_per_chunk // width))
    n_bands = -(-height // band_rows)
    cam_c = camera_consts(scene.camera, width, height)
    use_host = bool(os.environ.get("ZWRT_ADAPTIVE_HOST"))
    sort_lanes = not (cs.has_sph_tree or cs.has_quad_tree)
    half = pilot // 2
    base = reserve_base(spp, pilot)
    tile = pick_tile(width, band_rows)
    kw = dict(
        width=width, height=height, band_rows=band_rows, spp=spp,
        max_depth=renderer.max_ray_bounce_depth, sampler=renderer.sampler,
        has_dof=scene.camera.has_depth_of_field, cam_consts=cam_c,
        rr=renderer.russian_roulette, clamp=renderer.clamp_indirect,
    )

    fb_bands = []
    counts = np.zeros((height, width), np.int64) if return_stats else None
    for b in range(n_bands):
        y0 = b * band_rows
        rows = min(band_rows, height - y0)
        sum_a = _render_band_regen(scene, renderer.seed, y0, 0, s_par=1, sample_limit=half, **kw)
        sum_b = _render_band_regen(scene, renderer.seed, y0, half, s_par=1, sample_limit=pilot,
                                   **kw)
        extra_total = (spp - pilot - base) * rows * width
        if use_host:
            sa = sum_a[:rows].cpu().numpy()
            sb = sum_b[:rows].cpu().numpy()
            weight = variance_weights(sa / half, sb / half)
            n_extra = base + allocate_extra(weight, extra_total, cap - base)
            n_full = np.zeros((band_rows, width), np.int64)
            n_full[:rows] = n_extra
            plan = build_adaptive_plan(n_full, y0, pilot, tile, lane_cap, sort_lanes=sort_lanes)
            px, py, s0, s1 = (torch.as_tensor(a, device=cs.device) for a in plan)
            n_extra = torch.as_tensor(n_extra.astype(np.int32), device=cs.device)
        else:
            order = torch.as_tensor(np.argsort(
                tile_order_lane_index(width, band_rows, tile).reshape(-1), kind="stable",
            ).astype(np.int64), device=cs.device)
            n_extra, px, py, s0, s1 = plan_pipeline(
                sum_a, sum_b, order, half=half, base=base, extra_total=extra_total, cap=cap,
                band_y0=y0, pilot=pilot, lane_cap=lane_cap, sort_lanes=sort_lanes,
                m_lanes=plan_lane_budget(band_rows * width, THREADS), width=width,
                rows_eff=rows,
            )
        extra = _render_band_balanced(scene, renderer.seed, y0, px, py, s0, s1, **kw)
        n_pix = pilot + n_extra
        fb_bands.append((sum_a + sum_b + extra)[:rows] / n_pix[..., None].to(real))
        if return_stats:
            counts[y0 : y0 + rows] = n_pix.cpu().numpy()

    fb = fb_bands[0] if len(fb_bands) == 1 else torch.cat(fb_bands, dim=0)
    if return_stats:
        return fb, {"n_samples": counts, "pilot": pilot}
    return fb
