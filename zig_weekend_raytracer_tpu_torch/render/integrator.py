"""The wavefront integrators (counterpart of ``render/integrator.py``) and
the plain PyTorch versions of the render kernels.

``trace_paths_regen`` renders a lane plan: scenes without image textures,
and image scenes with a texture LUT, go to the whole-render kernel
(``ops/fused_render.py``); other image scenes to the bounce kernel's
regenerating mode (``ops/bounce.py``) under the driver's
``while any(alive | sample + stride < limit)`` loop.  That kernel
reads the texel at the hit and drains every lane's window in one launch,
so the loop runs one pass per band (``trace_paths_regen.passes``).  While
``utils/profiler.py`` records, each pass's ``bounce_regen`` call is the
span ``render.regen.launch`` (the host's checks, packing and enqueue, with
the read of the window ends inside it, ``render.regen.launch.wait``) and
each read of the loop's condition, where the host waits for the launch
before, ``render.regen.poll``.

``render_fused_reference`` (the fused render kernel's plain version),
``bounce_regen_reference`` (the bounce kernel's regenerating mode) and
``bounce`` (its one-bounce mode) are the same estimator, bounce for
bounce, on (N,) tensors.  ``render_fused_items_reference`` runs the first
over the fused kernel's work queue (``item_windows``: each lane's window
cut into chunks) and sums each lane's chunks in the kernel's order.  Each lane owns one pixel and a sample window
[s0, s1) walked with ``stride``; a lane whose path ended respawns its
pixel's next sample, so a pass of the drain loop is: respawn,
``work += alive``, trace, shade, scatter.

Semantics (the reference's rayColor, unrolled into a throughput product):
miss -> background and the path ends; emission on front faces; emissive
hits and absorbed metal end the path; specular materials multiply by their
attenuation; diffuse scatter uses the 50/50 mixture of the light-list PDF
and the material PDF when the scene has lights; a zero-probability sample
or a path whose throughput hits exactly zero ends; a path ends after
``max_depth`` bounces.  An image texture's colour is the texel at the
hit's (u, v), from the texture LUT or the atlas, multiplied in at the hit
(and added on emission) as the JAX package's XLA integrator and its
whole-render kernel do.  The trace is ``ops/trace.py:closest_hit`` (brute
scan or group-tree walk per primitive kind, or one walk of the unified
tree, in the walk that ``ZWRT_TRAV`` names at each call, as the kernels'
``trace_closest<WALK>``); camera rays start on the defocus disk when the
camera has depth of field.  All randomness is content-addressed by
(seed, ray id, site): bounce d draws at sites 8 + 4d + k
(k = 0 scatter, 1 light mixture, 2 gaussian triple, 3 Russian roulette).

``trace_paths`` is the fixed-depth wavefront, the path of scenes that
no render kernel takes (nested checkers: ``ops/bounce.py:
supports_bounce_kernel``): one camera ray per lane, all lanes bouncing
together while any is alive, up to ``max_depth`` bounces.  Each bounce is
``bounce`` with the closest-hit kernel as its trace
(``ops/closest_hit.py``: K3 on the card, its plain cond walk on the CPU);
the rest of the bounce, the general texture walk of nested scenes
included, is eager PyTorch, as the JAX package shades this path in XLA.

Two estimator options, both off by default (the reference's semantics),
follow the JAX package's kernels (``ops/pallas_bounce.py:_bounce_core``)
and their gate (``_base_cfg``: off on an image scene without a texture
LUT; ``estimator_options``):

  * Russian roulette from bounce ``rr_start`` on: a live path continues
    with p = clamp(max(incoming throughput), RR_P_MIN, 1) against the
    site-3 draw, and its throughput carries 1 / p;
  * the indirect clamp: a contribution landed at bounce d >= 1 (the
    background at a miss, emission at a hit) is scaled so that its
    luminance is at most ``clamp``.

``trace_paths`` gates both as the JAX package's does
(``integrator.py:trace_paths``): off on every image scene, LUT or not.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..dtypes import INF, LUM_B, LUM_G, LUM_R, T_MIN, real
from ..materials import schlick_reflectance, scattering_pdf
from ..math import v3
from ..math.v3 import V3
from ..ops.shade import shade_attrs
from ..ops.trace import closest_hit
from ..sampling import hashrng
from ..scene import (
    MAT_DIELECTRIC,
    MAT_DIFFUSE_LIGHT,
    MAT_ISOTROPIC,
    MAT_LAMBERTIAN,
    MAT_METAL,
    PRIM_SPHERE,
    CompiledScene,
)
from ..textures import checker_parity, image_lookup, texture_value
from ..utils import workcount
from ..utils.profiler import count, named_zone, recording
from .camera import camera_params_from_consts, generate_rays
from .pdfs import light_pdf_value, sample_light_direction


BOUNCE_BASE = 8
SITES_PER_BOUNCE = 4
_MATERIALS = (
    (MAT_LAMBERTIAN, "lambertian"), (MAT_ISOTROPIC, "isotropic"), (MAT_METAL, "metal"),
    (MAT_DIELECTRIC, "dielectric"), (MAT_DIFFUSE_LIGHT, "emissive"),
)


def texture_rgb(scene: CompiledScene, det):
    """Texture value at a hit from its shade record: solid -> rgb; checker
    -> the lattice parity picks rgb / rgb2 or an image child; image -> the
    texel at (u, v), from the texture LUT when the scene has one (as the
    JAX whole-render kernel fetches it, pallas_bounce.py:1391-1401) and
    from the atlas otherwise.  Nested checkers do not fit the record: their
    scenes take the general walk from the record's texture id
    (``textures.py:texture_value``, the atlas texel, as in the JAX
    package).  Returns (colour, image id or -1; None without record
    images)."""
    if scene.has_nested_checker:
        return texture_value(scene, det.texid, det.u, det.v, det.point), None
    odd = (det.tex_kind == 1) & (checker_parity(det.inv_scale, det.point) != 0)
    rgb = V3.where(odd, det.rgb2, det.rgb)
    if not scene.has_image_textures:
        return rgb, None
    img_id = torch.where(odd, det.img2, det.img)
    img_rgb = image_lookup(scene, torch.clamp(img_id, min=0), det.u, det.v)
    return V3.where(img_id >= 0, img_rgb, rgb), img_id


def estimator_options(scene: CompiledScene, rr_start, clamp):
    """(rr_start, clamp) as the kernels apply them: both off (0, 0.0) on
    an image scene without a texture LUT, as the JAX kernels' config gates
    them (pallas_bounce.py:_base_cfg); ``clamp`` as its float32 value."""
    if scene.has_image_textures and not scene.tex_lut_dims:
        return 0, 0.0
    return int(rr_start), float(np.float32(clamp))


def _clamp_contrib(c: V3, depth, clamp: float) -> V3:
    """A radiance contribution landed at bounce ``depth``, scaled where
    depth >= 1 so that its luminance is at most ``clamp``."""
    lum = LUM_R * c.x + LUM_G * c.y + LUM_B * c.z
    scale = torch.where((depth >= 1) & (lum > clamp),
                        clamp / torch.clamp(lum, min=1e-20), 1.0)
    return c * scale


def _count_bounce(alive, missed, hitmask, hit, det, img_id):
    workcount.add("bounce", alive.sum())
    workcount.add("miss", missed.sum())
    for code, name in _MATERIALS:
        workcount.add(f"hit_{name}", (hitmask & (det.mat_type == code)).sum())
    workcount.add("checker", (hitmask & (det.tex_kind == 1)).sum())
    is_sphere = hit.kind == PRIM_SPHERE
    workcount.add("hit_sphere", (hitmask & is_sphere).sum())
    if img_id is not None:
        texel = hitmask & (img_id >= 0)
        workcount.add("texel_sphere", (texel & is_sphere).sum())
        workcount.add("texel_quad", (texel & ~is_sphere).sum())


def bounce(
    scene: CompiledScene, seed, t_min, depth: torch.Tensor,
    origin: V3, direction: V3, time, ray_id, throughput: V3, radiance: V3,
    alive: torch.Tensor, rr_start: int = 0, clamp: float = 0.0, *, trace=closest_hit,
):
    """One masked integrator bounce for every lane: the plain version of
    the bounce kernel's one-bounce mode.  ``depth`` is each lane's bounce
    index (or one for all); ``rr_start`` and ``clamp`` the estimator
    options, gated by ``estimator_options``.  ``trace`` finds the hits
    (``ops/trace.py:closest_hit``; ``trace_paths`` passes the closest-hit
    kernel's wrapper).  Returns (origin', direction', throughput',
    radiance', survives)."""
    bounce.calls += 1
    rr_start, clamp = estimator_options(scene, rr_start, clamp)
    n = origin.shape[0]
    dev = origin.x.device
    site = BOUNCE_BASE + depth.to(torch.int64) * SITES_PER_BOUNCE
    u0, u1, u2, u3 = hashrng.uniform4(seed, ray_id, site)
    if scene.has_lights:
        u4, u5, u6, _ = hashrng.uniform4(seed, ray_id, site + 1)
    if scene.needs_gauss:
        gauss = hashrng.gauss3(seed, ray_id, site + 2)
    if rr_start:
        u_rr = hashrng.uniform1(seed, ray_id, site + 3)

    hit = trace(scene, origin, direction, time, t_min, INF, active=alive)
    det = shade_attrs(scene, hit, origin, direction, time)

    hit_any = hit.kind >= 0
    hitmask = alive & hit_any
    missed = alive & ~hit_any
    zeros = V3.zeros((n,), dev)
    contrib = ((lambda c: _clamp_contrib(c, depth, clamp)) if clamp
               else (lambda c: c))
    radiance = radiance + V3.where(missed, contrib(throughput * scene.background), zeros)

    mat_type = det.mat_type
    tex_rgb, img_id = texture_rgb(scene, det)
    if workcount.enabled():
        _count_bounce(alive, missed, hitmask, hit, det, img_id)

    # ---- emission ----
    is_emissive = mat_type == MAT_DIFFUSE_LIGHT
    emits = hitmask & is_emissive & det.front
    radiance = V3.where(emits, radiance + contrib(throughput * tex_rgb), radiance)

    # ---- metal ----
    reflected = v3.reflect(direction, det.normal)
    if scene.needs_gauss:
        fuzz = torch.clamp(det.fuzz, 0.0, 1.0)
        metal_dir = reflected + hashrng.unit_sphere(gauss) * fuzz
    else:
        metal_dir = reflected
    metal_ok = v3.dot(metal_dir, det.normal) > 0.0

    # ---- dielectric ----
    ri = det.refract
    index = torch.where(det.front, 1.0 / ri, ri)
    unit_in = v3.normalize(direction)
    cos_theta = torch.clamp(v3.dot(-unit_in, det.normal), max=1.0)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    must_reflect = (index * sin_theta > 1.0) | (schlick_reflectance(cos_theta, ri) > u0)
    diel_dir = V3.where(
        must_reflect,
        v3.reflect(unit_in, det.normal),
        v3.refract(unit_in, det.normal, index),
    )

    # ---- diffuse sampling (lambertian cosine / isotropic sphere) ----
    basis = v3.ortho_basis(det.normal)
    cosine_dir = v3.onb_transform(basis, hashrng.cosine_direction_z(u1, u2))
    if scene.needs_gauss:
        is_iso = mat_type == MAT_ISOTROPIC
        mat_sample_dir = V3.where(is_iso, hashrng.unit_sphere(gauss), cosine_dir)
    else:
        mat_sample_dir = cosine_dir

    if scene.has_lights:
        light_dir = sample_light_direction(scene, det.point, u4, u5, u6)
        diff_dir = V3.where(u3 < 0.5, light_dir, mat_sample_dir)
        mat_pdf = scattering_pdf(mat_type, det.normal, diff_dir)
        l_pdf = light_pdf_value(scene, det.point, diff_dir)
        sample_pdf = 0.5 * l_pdf + 0.5 * mat_pdf
        scatter_pdf = mat_pdf
    else:
        diff_dir = mat_sample_dir
        scatter_pdf = scattering_pdf(mat_type, det.normal, diff_dir)
        sample_pdf = scatter_pdf

    pdf_ok = sample_pdf > 0.0
    pdf_ratio = torch.where(
        pdf_ok, scatter_pdf / torch.where(pdf_ok, sample_pdf, 1.0), 0.0
    )
    diffuse_mult = tex_rgb * pdf_ratio

    # ---- combine by material type ----
    is_metal = mat_type == MAT_METAL
    is_diel = mat_type == MAT_DIELECTRIC
    new_dir = V3.where(
        is_metal | is_diel, V3.where(is_metal, metal_dir, diel_dir), diff_dir
    )
    one = V3.full((n,), 1.0, 1.0, 1.0, dev)
    mult = V3.where(is_metal, det.rgb, V3.where(is_diel, one, diffuse_mult))

    survives = hitmask & ~is_emissive & ~(is_metal & ~metal_ok)
    incoming = throughput
    throughput = V3.where(survives, throughput * mult, throughput)
    nonzero = (throughput.x != 0.0) | (throughput.y != 0.0) | (throughput.z != 0.0)
    survives = survives & nonzero
    if rr_start:
        # p from the incoming throughput; survivors carry 1 / p
        p_rr = torch.clamp(
            torch.maximum(incoming.x, torch.maximum(incoming.y, incoming.z)),
            hashrng.RR_P_MIN, 1.0,
        )
        apply_rr = alive & (depth >= rr_start)
        survives = survives & ~(apply_rr & (u_rr >= p_rr))
        throughput = throughput * torch.where(apply_rr, 1.0 / p_rr, 1.0)
    return (
        V3.where(hitmask, det.point, origin),
        V3.where(hitmask, new_dir, direction),
        throughput,
        radiance,
        survives,
    )


bounce.calls = 0


def trace_paths(
    scene: CompiledScene, origin: V3, direction: V3, time, seed, ray_id, max_depth: int,
    rr_start: int = 0, clamp: float = 0.0,
) -> V3:
    """The fixed-depth wavefront (module doc): radiance of each ray of
    (N,) ``origin``, ``direction``, ``time`` and u32 ``ray_id`` (int64),
    bouncing every live lane together until none is alive or ``max_depth``
    bounces have run.  Russian roulette from bounce ``rr_start`` and the
    indirect ``clamp`` (0: off) are off on image scenes, as in the JAX
    package's ``trace_paths``.  ``trace_paths.bounces`` counts bounces.
    While ``utils/profiler.py`` records, each read of the loop's condition
    (the host waits for the bounce before) is the span
    ``render.fixed.sync``, each bounce (its draws, K3's launch and the
    shading's enqueue) ``render.fixed.bounce``, and the counters
    ``fixed.bounces``, ``fixed.lane_slots`` (the chunk's lanes, each
    bounce) and ``fixed.live_lanes`` (the live lanes entering each bounce,
    read at that sync in the place of ``alive.any()``) add up."""
    from ..ops.closest_hit import closest_hit as closest_hit_kernel

    if scene.has_image_textures:
        rr_start, clamp = 0, 0.0
    n = origin.shape[0]
    dev = origin.x.device
    throughput = V3.full((n,), 1.0, 1.0, 1.0, dev)
    radiance = V3.zeros((n,), dev)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    depth = 0
    while depth < max_depth:
        with named_zone("render.fixed.sync"):
            if recording():  # the live lanes' count in the read's place
                live = int(alive.sum())
                more = live > 0
            else:
                live, more = None, bool(alive.any())
        if not more:
            break
        trace_paths.bounces += 1
        count("fixed.bounces")
        count("fixed.lane_slots", n)
        if live is not None:
            count("fixed.live_lanes", live)
        with named_zone("render.fixed.bounce"):
            origin, direction, throughput, radiance, alive = bounce(
                scene, seed, T_MIN, torch.tensor(depth, dtype=torch.int64, device=dev), origin,
                direction, time, ray_id, throughput, radiance, alive, rr_start, clamp,
                trace=closest_hit_kernel,
            )
        depth += 1
    return radiance


trace_paths.bounces = 0


class RegenState(NamedTuple):
    """Per-lane state of the regenerating drain.  ``ray_id`` holds u32
    values in int64; ``sample`` is the lane's current sample, ``bounce``
    its path's bounce index and ``work`` the count of loop passes in which
    the lane was alive (int32)."""

    origin: V3
    direction: V3
    time: torch.Tensor
    ray_id: torch.Tensor
    throughput: V3
    radiance: V3
    alive: torch.Tensor
    sample: torch.Tensor
    bounce: torch.Tensor
    work: torch.Tensor


def initial_regen_state(first_sample: torch.Tensor, stride: int) -> RegenState:
    """Every lane dead, one stride before its first sample, so that the
    first pass respawns it."""
    n = first_sample.shape[0]
    dev = first_sample.device
    i32 = lambda: torch.zeros((n,), dtype=torch.int32, device=dev)
    return RegenState(
        origin=V3.zeros((n,), dev),
        direction=V3.full((n,), 0.0, 0.0, 1.0, dev),
        time=torch.zeros((n,), dtype=real, device=dev),
        ray_id=torch.zeros((n,), dtype=torch.int64, device=dev),
        throughput=V3.full((n,), 1.0, 1.0, 1.0, dev),
        radiance=V3.zeros((n,), dev),
        alive=torch.zeros((n,), dtype=torch.bool, device=dev),
        sample=(first_sample.to(torch.int64) - stride).to(torch.int32),
        bounce=i32(),
        work=i32(),
    )


def _drain(
    scene: CompiledScene, st: RegenState, px, py, limit, seed, t_min, *,
    camera_consts, sampler, width: int, height: int, spp: int, stride: int,
    max_depth: int, has_dof: bool, rr_start: int = 0, clamp: float = 0.0,
) -> RegenState:
    """Run every lane until its window is used up: respawn, work, bounce."""
    cam = camera_params_from_consts(camera_consts)
    px = px.to(torch.int64)
    py = py.to(torch.int64)
    limit = limit.to(torch.int64)
    sample = st.sample.to(torch.int64)
    depth = st.bounce.to(torch.int64)
    origin, direction, time, ray_id = st.origin, st.direction, st.time, st.ray_id
    throughput, radiance, alive, work = st.throughput, st.radiance, st.alive, st.work
    one = V3.full((px.shape[0],), 1.0, 1.0, 1.0, px.device)

    while bool(torch.any(alive | (sample + stride < limit))):
        # respawn: dead lanes take their pixel's next sample
        next_sample = sample + stride
        respawn = ~alive & (next_sample < limit)
        if workcount.enabled():
            workcount.add("camera_ray", respawn.sum())
        sample = torch.where(respawn, next_sample, sample)
        new_rid = ((sample * height + py) * width + px) & hashrng.U32_MASK
        ray_id = torch.where(respawn, new_rid, ray_id)
        o_new, d_new, t_new = generate_rays(
            cam, has_dof, sampler, seed, new_rid, px, py, sample,
            spp, width, height,
        )
        origin = V3.where(respawn, o_new, origin)
        direction = V3.where(respawn, d_new, direction)
        time = torch.where(respawn, t_new, time)
        throughput = V3.where(respawn, one, throughput)
        depth = torch.where(respawn, 0, depth)
        alive = alive | respawn
        work = work + alive.to(torch.int32)

        origin, direction, throughput, radiance, survives = bounce(
            scene, seed, t_min, depth, origin, direction, time, ray_id,
            throughput, radiance, alive, rr_start, clamp,
        )
        # a dead lane keeps its path's last bounce index while others run
        depth = depth + alive.to(depth.dtype)
        alive = survives & (depth < max_depth)

    return RegenState(
        origin, direction, time, ray_id, throughput, radiance, alive,
        sample.to(torch.int32), depth.to(torch.int32), work,
    )


def render_fused_reference(
    scene: CompiledScene,
    px: torch.Tensor, py: torch.Tensor, s0: torch.Tensor, s1: torch.Tensor,
    seed: int, t_min: float, *,
    camera_consts, sampler, width: int, height: int, spp: int, stride: int,
    max_depth: int, has_dof: bool, want_work: bool = False,
    rr_start: int = 0, clamp: float = 0.0,
):
    """Plain PyTorch version of the fused render kernel.  Per lane, renders
    samples s0, s0 + stride, ... below s1 of pixel (px, py) and returns the
    radiance sum as V3 (+ the per-lane count of loop passes in which the
    lane was alive, int32, when ``want_work``)."""
    render_fused_reference.calls += 1
    st = _drain(
        scene, initial_regen_state(s0, stride), px, py, s1, seed, t_min,
        camera_consts=camera_consts, sampler=sampler, width=width,
        height=height, spp=spp, stride=stride, max_depth=max_depth,
        has_dof=has_dof, rr_start=rr_start, clamp=clamp,
    )
    if want_work:
        return st.radiance, st.work
    return st.radiance


render_fused_reference.calls = 0


def item_windows(s0: torch.Tensor, s1: torch.Tensor, stride: int, chunk: int):
    """The items of the fused render kernel's work queue over lanes with
    windows [s0, s1) at ``stride``, ``chunk`` samples an item at most
    (``ops/fused_render.py:item_chunk``): (lane, first, end, chunks), the
    first three (chunks * N,) in the kernel's order, chunk-major.  Item
    c * N + l is chunk c of lane l: its samples from s0 + stride * c * chunk
    below min(s1, s0 + stride * (c + 1) * chunk), empty past the lane's
    window; ``chunks`` is what the longest window takes, at least 1."""
    n = s0.shape[0]
    s0, s1 = s0.to(torch.int64), s1.to(torch.int64)
    span = int((s1 - s0).max()) if n else 0
    chunks = max(1, -(-max(0, -(-span // stride)) // chunk))
    c = torch.arange(chunks, dtype=torch.int64, device=s0.device)[:, None]
    first = s0[None] + stride * chunk * c
    end = torch.minimum(s1[None], first + stride * chunk)
    lane = torch.arange(n, device=s0.device).repeat(chunks)
    i32 = torch.int32
    return lane, first.reshape(-1).to(i32), end.reshape(-1).to(i32), chunks


def render_fused_items_reference(
    scene: CompiledScene,
    px: torch.Tensor, py: torch.Tensor, s0: torch.Tensor, s1: torch.Tensor,
    seed: int, t_min: float, *, chunk: int, want_work: bool = False, **kw,
):
    """``render_fused_reference`` over the fused render kernel's work queue
    (``item_windows`` at ``chunk``), as the kernel sums it: each item
    rendered from zero, each lane's radiance its items' sums added in chunk
    order from zero, its work count theirs.  The same samples as the
    unsplit render; only float32 rounding of the sums differs."""
    n = px.shape[0]
    lane, first, end, chunks = item_windows(s0, s1, kw["stride"], chunk)
    rad, work = render_fused_reference(
        scene, px[lane].contiguous(), py[lane].contiguous(), first, end, seed, t_min,
        want_work=True, **kw)
    sums = []
    for part in (rad.x, rad.y, rad.z):
        acc = torch.zeros((n,), dtype=part.dtype, device=part.device)
        for c in range(chunks):
            acc = acc + part[c * n:(c + 1) * n]
        sums.append(acc)
    rad = V3(*sums)
    if want_work:
        return rad, work.view(chunks, n).sum(dim=0, dtype=torch.int32)
    return rad


def bounce_regen_reference(
    scene: CompiledScene, state: RegenState, px, py, sample_limit, seed,
    t_min, *, camera_consts, sampler, width: int, height: int, spp: int,
    stride: int, max_depth: int, has_dof: bool, rr_start: int = 0,
    clamp: float = 0.0,
) -> RegenState:
    """Plain PyTorch version of the bounce kernel's regenerating mode: from
    ``state``, drains every lane's samples below ``sample_limit``
    (respawning its pixel's next sample as a path ends) and returns the
    final state."""
    bounce_regen_reference.calls += 1
    return _drain(
        scene, state, px, py, sample_limit, seed, t_min,
        camera_consts=camera_consts, sampler=sampler, width=width,
        height=height, spp=spp, stride=stride, max_depth=max_depth,
        has_dof=has_dof, rr_start=rr_start, clamp=clamp,
    )


bounce_regen_reference.calls = 0


def bounce_regen_items_reference(
    scene: CompiledScene, state: RegenState, px, py, sample_limit, seed, t_min, *,
    chunk: int, **kw,
) -> RegenState:
    """``bounce_regen_reference`` over the bounce kernel's work queue, as
    the kernel runs it: each lane's window from ``state.sample + stride``
    below ``sample_limit`` cut into ``item_windows`` at ``chunk``; a lane's
    chunk 0 resumes the state the lane was given (its live path, radiance
    and work), every other item starts dead from zero; each lane's radiance
    and work add its items' in chunk order from zero, and its other fields
    are those its last item leaves (the item with its last sample, or
    chunk 0 where it has none).  The same samples as the unsplit drain; only
    float32 rounding of the sums differs."""
    n = px.shape[0]
    stride = kw["stride"]
    s0 = (state.sample.to(torch.int64) + stride).to(torch.int32)
    lane, first, end, chunks = item_windows(s0, sample_limit, stride, chunk)
    start = initial_regen_state(first, stride)
    given = [torch.cat([g, f[n:]]) if isinstance(g, torch.Tensor) else
             V3(*(torch.cat([a, b[n:]]) for a, b in zip(g, f)))
             for g, f in zip(state, start)]
    st = _drain(scene, RegenState(*given), px[lane].contiguous(), py[lane].contiguous(), end,
                seed, t_min, **kw)
    span = sample_limit.to(torch.int64) - s0.to(torch.int64)
    last = ((torch.clamp(-(-span // (stride * chunk)), min=1) - 1) * n
            + torch.arange(n, device=px.device))
    pick = lambda t: V3(t.x[last], t.y[last], t.z[last]) if isinstance(t, V3) else t[last]
    out = RegenState(*(pick(t) for t in st))

    def in_order(t):
        acc = torch.zeros((n,), dtype=t.dtype, device=t.device)
        for c in range(chunks):
            acc = acc + t[c * n:(c + 1) * n]
        return acc

    return out._replace(radiance=V3(*(in_order(t) for t in st.radiance)),
                        work=in_order(st.work))


def trace_paths_regen(
    scene: CompiledScene, camera_consts, seed, px, py, first_sample,
    sample_limit, *, sampler, width: int, height: int, spp: int, stride: int,
    max_depth: int, has_dof: bool, want_work: bool = False, rr_start: int = 0,
    clamp: float = 0.0,
):
    """Render each lane's samples first_sample, + stride, ... below
    sample_limit of pixel (px, py); lane tensors are (N,) int32.  Returns
    the per-lane radiance sum as V3 (+ the per-lane work count when
    ``want_work``).  Scenes the whole-render kernel takes
    (``supports_fused_render``: no images, or a texture LUT) go there; other
    image scenes take the bounce kernel's regenerating mode under the
    driver loop, whose passes ``trace_paths_regen.passes`` counts.
    ``rr_start`` and ``clamp`` are the estimator options (module
    docstring), off on the bounce kernel's atlas scenes."""
    from ..ops.bounce import bounce_regen, supports_bounce_kernel, supports_fused_render
    from ..ops.fused_render import render_fused

    if not supports_bounce_kernel(scene):
        raise ValueError("nested checkers take the fixed-depth wavefront (trace_paths), "
                         "not the regenerating one")

    kw = dict(
        camera_consts=camera_consts, sampler=sampler, width=width,
        height=height, spp=spp, stride=stride, max_depth=max_depth,
        has_dof=has_dof, rr_start=rr_start, clamp=clamp,
    )
    if supports_fused_render(scene):
        return render_fused(
            scene, px, py, first_sample, sample_limit, seed, T_MIN,
            want_work=want_work, **kw,
        )
    trace_paths_regen.bands += 1
    st = initial_regen_state(first_sample, stride)
    limit = sample_limit.to(torch.int64)
    while True:
        with named_zone("render.regen.poll"):
            more = bool(torch.any(st.alive | (st.sample.to(torch.int64) + stride < limit)))
        if not more:
            break
        trace_paths_regen.passes += 1
        with named_zone("render.regen.launch"):
            st = bounce_regen(scene, st, px, py, sample_limit, seed, T_MIN, **kw)
    if want_work:
        return st.radiance, st.work
    return st.radiance


trace_paths_regen.passes = 0
trace_paths_regen.bands = 0
