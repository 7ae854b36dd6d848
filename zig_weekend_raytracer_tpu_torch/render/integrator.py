"""The regenerating wavefront integrator (counterpart of
``render/integrator.py``) and the plain PyTorch versions of the render
kernels.

``trace_paths_regen`` renders a lane plan: scenes without image textures,
and image scenes with a texture LUT, go to the whole-render kernel
(``ops/fused_render.py``); other image scenes to the bounce kernel's
regenerating mode (``ops/bounce.py``) under the driver's
``while any(alive | sample + stride < limit)`` loop.  That kernel
reads the texel at the hit and drains every lane's window in one launch,
so the loop runs one pass per band (``trace_paths_regen.passes``).

``render_fused_reference`` (the fused render kernel's plain version),
``bounce_regen_reference`` (the bounce kernel's regenerating mode) and
``bounce`` (its one-bounce mode) are the same estimator, bounce for
bounce, on (N,) tensors.  Each lane owns one pixel and a sample window
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
(k = 0 scatter, 1 light mixture, 2 gaussian triple).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..dtypes import INF, T_MIN, real
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
from ..textures import checker_parity, image_lookup
from ..utils import workcount
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
    from the atlas otherwise.  Returns (colour, image id or -1)."""
    odd = (det.tex_kind == 1) & (checker_parity(det.inv_scale, det.point) != 0)
    rgb = V3.where(odd, det.rgb2, det.rgb)
    if not scene.has_image_textures:
        return rgb, None
    img_id = torch.where(odd, det.img2, det.img)
    img_rgb = image_lookup(scene, torch.clamp(img_id, min=0), det.u, det.v)
    return V3.where(img_id >= 0, img_rgb, rgb), img_id


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
    alive: torch.Tensor,
):
    """One masked integrator bounce for every lane: the plain version of
    the bounce kernel's one-bounce mode.  ``depth`` is each lane's bounce
    index.  Returns (origin', direction', throughput', radiance',
    survives)."""
    bounce.calls += 1
    n = origin.shape[0]
    dev = origin.x.device
    site = BOUNCE_BASE + depth.to(torch.int64) * SITES_PER_BOUNCE
    u0, u1, u2, u3 = hashrng.uniform4(seed, ray_id, site)
    if scene.has_lights:
        u4, u5, u6, _ = hashrng.uniform4(seed, ray_id, site + 1)
    if scene.needs_gauss:
        gauss = hashrng.gauss3(seed, ray_id, site + 2)

    hit = closest_hit(scene, origin, direction, time, t_min, INF, active=alive)
    det = shade_attrs(scene, hit, origin, direction, time)

    hit_any = hit.kind >= 0
    hitmask = alive & hit_any
    missed = alive & ~hit_any
    zeros = V3.zeros((n,), dev)
    radiance = radiance + V3.where(missed, throughput * scene.background, zeros)

    mat_type = det.mat_type
    tex_rgb, img_id = texture_rgb(scene, det)
    if workcount.enabled():
        _count_bounce(alive, missed, hitmask, hit, det, img_id)

    # ---- emission ----
    is_emissive = mat_type == MAT_DIFFUSE_LIGHT
    emits = hitmask & is_emissive & det.front
    radiance = V3.where(emits, radiance + throughput * tex_rgb, radiance)

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
    throughput = V3.where(survives, throughput * mult, throughput)
    nonzero = (throughput.x != 0.0) | (throughput.y != 0.0) | (throughput.z != 0.0)
    survives = survives & nonzero
    return (
        V3.where(hitmask, det.point, origin),
        V3.where(hitmask, new_dir, direction),
        throughput,
        radiance,
        survives,
    )


bounce.calls = 0


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
    max_depth: int, has_dof: bool,
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
            throughput, radiance, alive,
        )
        depth = depth + 1
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
        has_dof=has_dof,
    )
    if want_work:
        return st.radiance, st.work
    return st.radiance


render_fused_reference.calls = 0


def bounce_regen_reference(
    scene: CompiledScene, state: RegenState, px, py, sample_limit, seed,
    t_min, *, camera_consts, sampler, width: int, height: int, spp: int,
    stride: int, max_depth: int, has_dof: bool,
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
        has_dof=has_dof,
    )


bounce_regen_reference.calls = 0


def trace_paths_regen(
    scene: CompiledScene, camera_consts, seed, px, py, first_sample,
    sample_limit, *, sampler, width: int, height: int, spp: int, stride: int,
    max_depth: int, has_dof: bool, want_work: bool = False,
):
    """Render each lane's samples first_sample, + stride, ... below
    sample_limit of pixel (px, py); lane tensors are (N,) int32.  Returns
    the per-lane radiance sum as V3 (+ the per-lane work count when
    ``want_work``).  Scenes the whole-render kernel takes
    (``supports_fused_render``: no images, or a texture LUT) go there; other
    image scenes take the bounce kernel's regenerating mode under the
    driver loop, whose passes ``trace_paths_regen.passes`` counts."""
    from ..ops.bounce import bounce_regen, supports_fused_render
    from ..ops.fused_render import render_fused

    kw = dict(
        camera_consts=camera_consts, sampler=sampler, width=width,
        height=height, spp=spp, stride=stride, max_depth=max_depth,
        has_dof=has_dof,
    )
    if supports_fused_render(scene):
        return render_fused(
            scene, px, py, first_sample, sample_limit, seed, T_MIN,
            want_work=want_work, **kw,
        )
    trace_paths_regen.bands += 1
    st = initial_regen_state(first_sample, stride)
    limit = sample_limit.to(torch.int64)
    while bool(torch.any(st.alive | (st.sample.to(torch.int64) + stride < limit))):
        trace_paths_regen.passes += 1
        st = bounce_regen(scene, st, px, py, sample_limit, seed, T_MIN, **kw)
    if want_work:
        return st.radiance, st.work
    return st.radiance


trace_paths_regen.passes = 0
trace_paths_regen.bands = 0
