"""Sharded rendering over a 1-D device mesh (counterpart of
``parallel/render.py``).

The JAX package runs its band renders under ``jax.shard_map`` and reduces
with a ``psum``; here one process loops over the mesh (``parallel/mesh.py``)
and launches each shard's bands on its device, band-major.  Once the plans
exist no launch waits on another shard's result, so distinct cards could
overlap (unmeasured: no run has had more than one card).  Every
shard runs the single-device band renders (``render/renderer.py``:
``_render_band_regen`` and ``_render_band_balanced``), so the render
kernel, or the bounce kernel's regenerating mode on atlas scenes, on the
card, and their plain versions on the CPU.  A device other than the
scene's gets a copy of its tables (``scene.compiled_on``).

  * ``shard='samples'``: device d renders every pixel's samples
    [sample0 + d * spp_local, min(end, sample0 + (d + 1) * spp_local)),
    spp_local = ceil(spp / n); the framebuffers are copied to ``mesh[0]``
    and summed there in device order, whether or not the devices repeat;
  * ``shard='rows'``: device d renders rows [d * rows_local, (d + 1) *
    rows_local), rows_local = ceil(height / n); padded rows render clamped
    duplicates and are sliced off; the blocks are concatenated.

Scenes that no render kernel takes (nested checkers) shard the fixed-depth
wavefront instead, as the JAX package does: each device renders bands x
sample chunks of ``_render_band`` over its slice, a chunk grid that
overshoots a device's sample slice counting nothing past its cap
(min(end, slice start + spp_local)), and the same reduction follows.

The RNG is content-addressed by global ray id, so the sharded render is the
single-device render up to float32 summation order; a one-device mesh is
bitwise ``Renderer.render`` of a brute scene.  Brute scenes at one sample
in flight per pixel (s_par = 1) follow cost-sorted plans from their second
render on, as the JAX package's do: the first render measures each lane's
work, summed over devices in samples mode; tree scenes take the plain lanes
(the single-device coherent plan is not used in shards, as in JAX).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import weakref
from typing import Optional

import numpy as np
import torch

from ..dtypes import real
from ..ops.bounce import supports_bounce_kernel
from ..ops.fused_render import THREADS
from ..render.camera import camera_consts
from ..render.renderer import (
    MAX_RAYS_PER_CHUNK,
    Renderer,
    _render_band_balanced,
    _render_band_regen,
    memo_plan_entry,
    pick_tile,
    sorted_plan,
    tile_order_lane_index,
)
from ..sampling.sampler import SamplerKind
from ..scene import Scene, compiled_on
from .mesh import SHARD_MODES, resolve_mesh

log = logging.getLogger("zwrt")

# Cost-sorted plans keyed weakly on the CompiledScene object (the policy of
# ``render/renderer.py:memo_plan_entry``).  An entry's "plans" are
# [device][band] (px, py, live) int32 tensors on that device.
_plan_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_PLAN_CACHE_MAX_CONFIGS = 8


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _plan_items(rows: int, width: int, blk: int = THREADS) -> int:
    return _cdiv(rows * width, blk) * blk


def _sortable(compiled, s_par) -> bool:
    # the single-device gate: one lane owns a pixel's whole sample range,
    # and no group trees (their walk wants spatially tight warps)
    return (s_par == 1 and not (compiled.has_sph_tree or compiled.has_quad_tree)
            and not os.environ.get("ZWRT_NO_SORT"))


def _on(device: torch.device):
    """The block's current device: CUDA launches go to ``device``."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _scenes_on(scene: Scene, mesh):
    """``scene`` with its tables on each device of ``mesh``."""
    return [scene if d == scene.compiled.device
            else dataclasses.replace(scene, compiled=compiled_on(scene.compiled, d))
            for d in mesh]


def _reduce_sum(parts, dest: torch.device) -> torch.Tensor:
    """The sum of equal-shape tensors, each copied to ``dest`` and added in
    list order."""
    total = parts[0].to(dest)
    for p in parts[1:]:
        total = total + p.to(dest)
    return total


def render_sharded(
    scene: Scene, width: int, height: int, samples_per_pixel: int, max_depth: int = 20,
    sampler: SamplerKind = SamplerKind.SOBOL, mesh=None, shard: str = "samples",
    seed: int = 0, max_rays_per_chunk: int = MAX_RAYS_PER_CHUNK, rr: int = 0, clamp: float = 0.0,
    regen_min_wave: Optional[int] = None, sample0: int = 0,
    sample_count: Optional[int] = None, normalize: bool = True,
) -> torch.Tensor:
    """Renders across ``mesh`` (default: ``make_mesh`` of the scene's device
    type).  Returns the (H, W, 3) float32 tensor on ``mesh[0]``: the average
    over ``samples_per_pixel``, or with ``normalize=False`` the radiance
    sum.  ``sample0`` / ``sample_count`` restrict the render to sample
    indices [sample0, sample0 + sample_count) of a ``samples_per_pixel``
    render (a progressive batch)."""
    if shard not in SHARD_MODES:
        raise ValueError(f"unknown shard mode: {shard}")
    mesh = resolve_mesh(mesh, scene.compiled.device)
    n_dev = len(mesh)
    spp = samples_per_pixel
    if width * height * spp >= 2**32:
        raise ValueError(f"ray id space {width}x{height}x{spp} exceeds u32; reduce spp")
    spp_now = spp - sample0 if sample_count is None else sample_count
    s_end = min(sample0 + spp_now, spp)
    chunker = Renderer(
        samples_per_pixel=spp, max_rays_per_chunk=max_rays_per_chunk,
        max_ray_bounce_depth=max_depth, sampler=sampler, seed=seed, russian_roulette=rr,
        clamp_indirect=clamp,
        **({"regen_min_wave": regen_min_wave} if regen_min_wave is not None else {}),
    )
    cs = scene.compiled
    if not supports_bounce_kernel(cs):
        fbs, rows_local = _fixed_depth_shards(scene, chunker, width, height, sample0, spp_now,
                                              s_end, mesh, shard)
        return _gather(fbs, shard, height, rows_local, mesh) / (spp if normalize else 1)
    cam_c = camera_consts(scene.camera, width, height)

    if shard == "samples":
        spp_local = _cdiv(spp_now, n_dev)
        s_par, band_rows = chunker.regen_geometry(width, height, spp_local)
        n_bands = _cdiv(height, band_rows)
        # the per-device cap: a device never renders the next one's samples
        windows = [(sample0 + d * spp_local, min(s_end, sample0 + (d + 1) * spp_local))
                   for d in range(n_dev)]
        y0s = [[b * band_rows for b in range(n_bands)]] * n_dev
    else:
        rows_local = _cdiv(height, n_dev)
        s_par, band_rows = chunker.regen_geometry(width, rows_local, spp_now)
        band_rows = min(band_rows, rows_local)
        n_bands = _cdiv(rows_local, band_rows)
        windows = [(sample0, s_end)] * n_dev
        y0s = [[d * rows_local + b * band_rows for b in range(n_bands)] for d in range(n_dev)]

    sortable = _sortable(cs, s_par)
    entry = None
    if sortable:
        key = (shard, width, height, spp, spp_now, max_depth, sampler, rr, clamp,
               max_rays_per_chunk, regen_min_wave, cam_c, tuple(map(str, mesh)), seed)
        entry = memo_plan_entry(_plan_cache, cs, key, _PLAN_CACHE_MAX_CONFIGS)
    plans = entry.get("plans") if entry is not None else None
    scenes = _scenes_on(scene, mesh)
    kw = dict(width=width, height=height, band_rows=band_rows, spp=spp, max_depth=max_depth,
              sampler=sampler, has_dof=scene.camera.has_depth_of_field, cam_consts=cam_c,
              rr=rr, clamp=clamp)
    fbs = [torch.zeros((n_bands * band_rows, width, 3), dtype=real, device=d) for d in mesh]
    works = [[None] * n_bands for _ in mesh]
    for b in range(n_bands):
        for d, sc in enumerate(scenes):
            y0, (s0, s1) = y0s[d][b], windows[d]
            with _on(mesh[d]):
                if plans is not None:
                    px, py, live = plans[d][b]
                    out = _render_band_balanced(sc, seed, y0, px, py, live * s0, live * s1,
                                                **kw)
                else:
                    out = _render_band_regen(sc, seed, y0, s0, s_par=s_par, sample_limit=s1,
                                             want_work=sortable, **kw)
                    if sortable:
                        out, works[d][b] = out
                fbs[d][b * band_rows : (b + 1) * band_rows] += out

    if sortable and plans is None:
        works = [[w.cpu().numpy().astype(np.int64) for w in per] for per in works]
        if shard == "samples":
            # every device's slice has the same per-pixel cost signal: the
            # work summed over devices
            band_plans = [
                sorted_plan(sum(works[d][b] for d in range(n_dev)), width, band_rows,
                            min(band_rows, height - b * band_rows), b * band_rows,
                            _plan_items(min(band_rows, height - b * band_rows), width))
                for b in range(n_bands)]
            per_dev = [band_plans] * n_dev
        else:
            n_items = _plan_items(band_rows, width)
            per_dev = [[sorted_plan(works[d][b], width, band_rows,
                                    min(band_rows, height - y0s[d][b]), y0s[d][b], n_items)
                        for b in range(n_bands)] for d in range(n_dev)]
        entry["plans"] = [[tuple(torch.as_tensor(a, device=dev) for a in p) for p in bands]
                          for dev, bands in zip(mesh, per_dev)]

    fb = _gather(fbs, shard, height, None if shard == "samples" else rows_local, mesh)
    return fb / spp if normalize else fb


def _gather(fbs, shard: str, height: int, rows_local, mesh) -> torch.Tensor:
    """The devices' framebuffers as one on ``mesh[0]``: in samples mode
    their sum in device order, in rows mode their first ``rows_local`` rows
    stacked."""
    if shard == "samples":
        return _reduce_sum([f[:height] for f in fbs], mesh[0])
    return torch.cat([f[:rows_local].to(mesh[0]) for f in fbs])[:height]


def _fixed_depth_shards(scene: Scene, chunker: Renderer, width: int, height: int,
                        sample0: int, spp_now: int, s_end: int, mesh, shard: str):
    """Each device's radiance-sum framebuffer of the fixed-depth wavefront
    over its slice (``Renderer._fixed_depth_fb``); and the rows of a
    device's slice in rows mode (None in samples mode)."""
    n_dev = len(mesh)
    if shard == "samples":
        rows_local = None
        spp_local = _cdiv(spp_now, n_dev)
        starts = [sample0 + d * spp_local for d in range(n_dev)]
        # the per-device cap: a chunk past a device's slice counts nothing
        slices = [(0, height, s, spp_local, min(s_end, s + spp_local)) for s in starts]
    else:
        rows_local = _cdiv(height, n_dev)
        slices = [(d * rows_local, rows_local, sample0, spp_now, s_end) for d in range(n_dev)]
    fbs = []
    for d, sc in enumerate(_scenes_on(scene, mesh)):
        with _on(mesh[d]):
            fbs.append(chunker._fixed_depth_fb(sc, *slices[d], width, height))
    return fbs, rows_local


def render_batch_sharded(
    scene: Scene, width: int, height: int, total_spp: int, sample0: int, spp_now: int,
    max_depth: int = 20, sampler: SamplerKind = SamplerKind.SOBOL, mesh=None,
    shard: str = "samples", seed: int = 0, max_rays_per_chunk: int = MAX_RAYS_PER_CHUNK, rr: int = 0,
    clamp: float = 0.0, regen_min_wave: Optional[int] = None,
) -> torch.Tensor:
    """The radiance sum over samples [sample0, sample0 + spp_now) of a
    ``total_spp`` render across ``mesh``: a progressive batch
    (``render/progressive.py``)."""
    return render_sharded(
        scene, width, height, total_spp, max_depth=max_depth, sampler=sampler, mesh=mesh,
        shard=shard, seed=seed, max_rays_per_chunk=max_rays_per_chunk, rr=rr, clamp=clamp,
        regen_min_wave=regen_min_wave, sample0=sample0, sample_count=spp_now,
        normalize=False,
    )


def render_adaptive_sharded(
    scene: Scene, width: int, height: int, samples_per_pixel: int, max_depth: int = 20,
    sampler: SamplerKind = SamplerKind.SOBOL, mesh=None, shard: str = "samples",
    seed: int = 0, max_rays_per_chunk: int = MAX_RAYS_PER_CHUNK, rr: int = 0, clamp: float = 0.0,
    pilot_spp: int = 0, return_stats: bool = False,
):
    """Variance-guided adaptive sampling (``render/adaptive.py``) across
    ``mesh``, at the uniform render's sample budget.

    ``shard='samples'``: the pilot halves render with each band's rows
    split over the devices, so every pixel's two pilot sums are bitwise the
    single-device ones and the plan, made once on ``mesh[0]``, is the
    single-device plan at any device count (the JAX package splits the
    pilot's samples instead, whose regrouped float32 sums can move a
    pixel's count); every lane's sample window of the extra pass is split
    over the devices with a ceiling, and the passes are summed.
    ``shard='rows'``: each device runs the whole pipeline on its rows, its
    padded rows with weight 0 and cap 0: the budget holds per device
    region, and a one-device mesh is bitwise ``render_adaptive`` at a
    height its bands divide.

    Returns the (H, W, 3) float32 tensor on ``mesh[0]``, and with
    ``return_stats`` a dict: ``n_samples`` (H, W) int64 and ``pilot``."""
    from ..render.adaptive import ADAPTIVE_UNIFORM, pick_pilot
    from ..render.adaptive_device import (
        allocate_extra_dev,
        build_adaptive_plan_dev,
        plan_lane_budget,
        plan_pipeline,
        reserve_base,
        variance_weights_dev,
    )

    if shard not in SHARD_MODES:
        raise ValueError(f"unknown shard mode: {shard}")
    if sampler == SamplerKind.STRATIFIED:
        raise ValueError(
            "adaptive sampling needs per-pixel sample counts; the "
            "stratified sampler's grid is fixed by spp — use sobol or "
            "independent"
        )
    mesh = resolve_mesh(mesh, scene.compiled.device)
    spp = samples_per_pixel
    pilot = pilot_spp or pick_pilot(spp)
    pilot = max(2, min(pilot, spp))
    pilot += pilot & 1  # two equal halves
    if not supports_bounce_kernel(scene.compiled):
        log.warning(ADAPTIVE_UNIFORM, spp)
        pilot = spp
    if pilot >= spp:
        fb = render_sharded(scene, width, height, spp, max_depth=max_depth, sampler=sampler,
                            mesh=mesh, shard=shard, seed=seed,
                            max_rays_per_chunk=max_rays_per_chunk, rr=rr, clamp=clamp)
        if return_stats:
            return fb, {"n_samples": np.full((height, width), spp, np.int64)}
        return fb
    cap = min(64 * (spp - pilot), (2**32) // (width * height) - pilot - 1)
    if cap < 1:
        raise ValueError(
            f"ray id space {width}x{height}x{spp} leaves no adaptive "
            "headroom; reduce spp or the image size"
        )
    lane_cap = max(8, 2 * (spp - pilot))
    base = reserve_base(spp, pilot)
    half = pilot // 2
    n_dev = len(mesh)
    cs = scene.compiled
    sort_lanes = not (cs.has_sph_tree or cs.has_quad_tree)
    scenes = _scenes_on(scene, mesh)
    rows_of = height if shard == "samples" else _cdiv(height, n_dev)
    band_rows = max(1, min(rows_of, max_rays_per_chunk // width))
    n_bands = _cdiv(rows_of, band_rows)
    order_np = np.argsort(tile_order_lane_index(width, band_rows, pick_tile(width, band_rows))
                          .reshape(-1), kind="stable")
    orders = {d: torch.as_tensor(order_np, device=d) for d in set(mesh)}
    m_lanes = plan_lane_budget(band_rows * width, THREADS)
    kw = dict(width=width, height=height, band_rows=band_rows, spp=spp, max_depth=max_depth,
              sampler=sampler, has_dof=scene.camera.has_depth_of_field,
              cam_consts=camera_consts(scene.camera, width, height), rr=rr, clamp=clamp)
    plan_kw = dict(pilot=pilot, lane_cap=lane_cap, sort_lanes=sort_lanes, m_lanes=m_lanes,
                   width=width)
    fb_bands, cnt_bands = [], []

    if shard == "samples":
        sub_rows = _cdiv(band_rows, n_dev)  # a device's rows of a band's pilot
        dest = mesh[0]
        for b in range(n_bands):
            y0 = b * band_rows
            rows = min(band_rows, height - y0)
            # every device's launches of both halves are queued before any
            # part is copied to ``dest``
            parts = {}
            for h0, h1 in ((0, half), (half, pilot)):
                for d, sc in enumerate(scenes[:_cdiv(band_rows, sub_rows)]):
                    with _on(mesh[d]):
                        parts.setdefault(h0, []).append(_render_band_regen(
                            sc, seed, y0 + d * sub_rows, h0, s_par=1, sample_limit=h1,
                            **{**kw, "band_rows": sub_rows}))
            sum_a, sum_b = (torch.cat([p.to(dest) for p in parts[h0]])[:band_rows]
                            for h0 in (0, half))
            n_extra, px, py, s0, s1 = plan_pipeline(
                sum_a, sum_b, orders[dest], half=half, base=base,
                extra_total=(spp - pilot - base) * rows * width, cap=cap, band_y0=y0,
                rows_eff=rows, **plan_kw)
            # each lane's window ceil-split over the devices
            length = s1 - s0
            q = (length + (n_dev - 1)) // n_dev
            parts = []
            for d, sc in enumerate(scenes):
                dev = mesh[d]
                d0 = s0 + torch.minimum(q * d, length)
                d1 = s0 + torch.minimum(q * (d + 1), length)
                with _on(dev):
                    parts.append(_render_band_balanced(
                        sc, seed, y0, px.to(dev), py.to(dev), d0.to(dev), d1.to(dev), **kw))
            extra = _reduce_sum(parts, dest)
            n_pix = pilot + n_extra
            fb_bands.append((sum_a + sum_b + extra)[:rows] / n_pix[..., None].to(real))
            cnt_bands.append(n_pix)
        fb = torch.cat(fb_bands)
        counts = torch.cat(cnt_bands)
    else:
        inv = float(1.0 / half)
        for d, sc in enumerate(scenes):
            dev = mesh[d]
            fb_d, cnt_d = [], []
            for b in range(n_bands):
                y0 = d * rows_of + b * band_rows
                n_valid = min(max(height - y0, 0), band_rows)
                with _on(dev):
                    sum_a = _render_band_regen(sc, seed, y0, 0, s_par=1, sample_limit=half,
                                               **kw)
                    sum_b = _render_band_regen(sc, seed, y0, half, s_par=1,
                                               sample_limit=pilot, **kw)
                    # rows past the image bottom render clamped duplicates:
                    # out of the noise map, and no allocation reaches them
                    valid = torch.arange(band_rows, device=dev) < n_valid
                    va = valid[:, None, None]
                    weight = variance_weights_dev(torch.where(va, sum_a, 0.0) * inv,
                                                  torch.where(va, sum_b, 0.0) * inv)
                    weight = torch.where(valid[:, None], weight, 0.0)
                    capv = torch.where(valid, cap - base, 0).to(torch.int32)[:, None].expand(
                        band_rows, width)
                    alloc = allocate_extra_dev(weight, (spp - pilot - base) * n_valid * width,
                                               capv)
                    n_extra = torch.where(valid[:, None], base + alloc, 0)
                    px, py, s0, s1 = build_adaptive_plan_dev(n_extra, orders[dev], band_y0=y0,
                                                             **plan_kw)
                    extra = _render_band_balanced(sc, seed, y0, px, py, s0, s1, **kw)
                    n_pix = pilot + n_extra
                    fb_d.append((sum_a + sum_b + extra) / n_pix[..., None].to(real))
                    cnt_d.append(n_pix)
            fb_bands.append(torch.cat(fb_d)[:rows_of])
            cnt_bands.append(torch.cat(cnt_d)[:rows_of])
        fb = torch.cat([f.to(mesh[0]) for f in fb_bands])[:height]
        counts = torch.cat([c.to(mesh[0]) for c in cnt_bands])[:height]
    if return_stats:
        return fb, {"n_samples": counts.cpu().numpy().astype(np.int64), "pilot": pilot}
    return fb
