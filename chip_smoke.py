#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Phases (any failure exits nonzero):
  1. device: the card's name and power limit, then the kernel build from
     zig_weekend_raytracer_tpu_torch/csrc/ (seconds, registers, spills);
  2. kernel against plain: render_fused on CUDA tensors at cornell 32x32,
     8 spp, depth 10, through the kernel and through its plain PyTorch
     version; work counts equal on >= 99% of lanes, radiance within
     rtol 1e-4 / atol 1e-5 on >= 99% of lanes, means within 1e-4 relative;
  3. the main path: Renderer(samples_per_pixel=1024, max_ray_bounce_depth=10)
     .render_device(load_scene("cornell_box", device="cuda"), 400, 400), one
     warmup render (records the cost map) and three timed renders; the
     framebuffer passes the region gate of
     tests/golden/bench_cornell_regions.json, the kernel launched during the
     phase and the plain version did not run;
  4. kernel against plain at the main path's lanes: the plain version at
     the sorted plan's 160,000 lanes with the largest spp <= 1024 expected
     to finish in about 60 s, beside the kernel at the same spp, and both
     at the full 1024 spp on a spread slice of 4,096 of those lanes (every
     Sobol sample bit); both outputs held to the tolerances of phase 2,
     both times printed;
  5. closest_hit_kernel against its plain version (ops/trace.py) on the
     card, 160,000 rays each: (a) cornell camera rays at 400x400 (brute
     spheres and quads), (b) balls first-hit probe rays at 400x400 (sphere
     tree, one 512-slot leaf), (c) the same rays on balls compiled with
     leaf span 2 (a multi-node walk), (d) random rays in a seeded random
     scene of 100 spheres and 600 quads with use_bvh (a multi-node quad
     tree seeded with the sphere result); (kind, idx) equal on >= 99.9%
     of rays, t within rtol 1e-5 / atol 1e-6 where they agree; the counts
     that differ and both times printed;
  6. render_fused with the tree walk and depth of field against its plain
     version: balls 32x32, 8 spp, depth 10, at the default leaf span and
     at span 2, with phase 2's tolerances; both times printed;
  7. the balls main path: Renderer(samples_per_pixel=128,
     max_ray_bounce_depth=10).render_device(load_scene("balls",
     device="cuda"), 400, 400), one warmup render (its first-hit probe
     builds the coherent plan) and three timed renders; over those four
     renders the coherent driver ran, closest_hit_kernel and
     fused_render_kernel each launched, and neither plain version ran;
     Mpaths/s printed beside the card; then the kernel against its plain
     version on a spread slice of 4,096 lanes of the coherent plan at the
     full 128 spp;
  8. the balls region gates on the card, both through utils/goldengate.py:
     200x200, 32 spp, depth 10 against tests/golden/scene_regions.json,
     and 64x64, 32 spp, depth 10 against tests/golden/balls.npz;
  9. bounce_kernel's one-bounce mode against its plain version
     (render/integrator.py:bounce): rtw_final camera rays at 400x400
     (160,000 lanes) through three chained bounces, and one bounce each on
     shrek_quads and earth; alive equal on >= 99.9% of lanes, the state
     within rtol 1e-5 / atol 1e-6 where alive agrees (origin and direction
     where the path goes on) on >= 99.9%; the counts that differ and both
     times printed;
 10. bounce_kernel's regenerating mode against its plain version
     (bounce_regen_reference): earth and shrek_quads at 32x32, 8 spp, depth
     10, rtw_final at 32x32, 8 spp, depth 8, with phase 2's tolerances (its
     1% lane allowance covers earth's texel boundaries); every lane drained;
 11. the rtw_final main path: Renderer(samples_per_pixel=64,
     max_ray_bounce_depth=8).render_device(load_scene("rtw_final"), 400,
     400), one warmup render and three timed; over the four renders the
     coherent plan was built, closest_hit_kernel and bounce_kernel launched,
     fused_render_kernel did not and no plain version ran; the driver
     loop's passes per band, Mpaths/s beside the card, bounce_kernel's time
     at the coherent plan, the kernel against its plain version on a spread
     slice of 4,096 plan lanes at 64 spp, and the peak device memory;
 12. the region gates of earth, shrek_quads and rtw_final on the card:
     200x200 against tests/golden/scene_regions.json (rtw_final at 32 spp,
     depth 8; the others at their recorded spp and depth 10), and 64x64,
     32 spp, depth 10 against tests/golden/{earth,shrek_quads,rtw_final}.npz
     (rtw_final on 4x4 regions, its 8x8-region verdict printed: see
     phase 12's comment);
 13. the render kernel with a texture LUT against its plain version, with
     phase 2's tolerances: rtw_final 32x32, 8 spp, depth 8 at a native
     budget and at 32768 texels, shrek_quads and earth at 8192 (depth 10),
     and a small scene whose lamp is image-textured, with a LUT (render
     kernel) and without (bounce kernel, regenerating mode); then the bounce
     kernel's one-bounce mode with a LUT on rtw_final's 160,000 camera rays
     with phase 9's tolerances;
 14. the LUT main path: Renderer(samples_per_pixel=64,
     max_ray_bounce_depth=8).render_device(load_scene("rtw_final",
     texture_lut=<native>), 400, 400), one warmup render and three timed;
     over the four renders the render kernel launched 4 times, the bounce
     kernel and every plain version never, the closest-hit kernel built
     the coherent plan; Mpaths/s, the render kernel's time at the plan's
     lanes, peak device memory; the framebuffer against phase 11's atlas
     render (same texels, same drain) within rtol 1e-5 / atol 1e-6 on >=
     99.9% of pixels; the render kernel with the LUT and the bounce kernel
     with the atlas timed on the same lanes in 10 alternating pairs; the
     kernel against its plain version on a spread slice of 2,048 plan
     lanes; the rtw_final region gates of phase 12 on the LUT scene; the
     same render at a 32768-texel budget, its Mpaths/s and mean
     |diff| to the native render printed (lossy by design, not gated);
 15. emissive (the CLI's default scene): the render kernel against its
     plain version at 32x32, 8 spp, depth 10; Renderer(samples_per_pixel=
     256, max_ray_bounce_depth=10).render_device at 400x400 through the
     render kernel only (sorted plan), Mpaths/s; its region gates at 200x200
     (scene_regions.json) and 64x64 (tests/golden/emissive.npz);
 16. the CLI (python -m zig_weekend_raytracer_tpu_torch.cli) as
     subprocesses: emissive 200x200, 64 spp, depth 10 and rtw_final with
     --texture_lut=32768 at 128x128, 16 spp, depth 10, each exiting 0 with
     the three stage log lines and the stats line, its PPM byte-equal to
     write_ppm of the same render made in this process; --scene=bogus
     exiting 1 with the usage text; --profile=device on cornell printing a
     device table that names fused_render_kernel.

The record has one entry per kernel and mode: the render kernel on brute
scenes (cornell, emissive), on tree scenes (balls) and with the texture LUT
(rtw_final), the bounce kernel's one-bounce mode with the atlas and with
the LUT (parity checks only: no main path runs it, so its launches are 0)
and its regenerating mode (rtw_final), and the closest-hit kernel.  Each
carries its registers and spill from the build, its times, its launches on
the main paths and its roofline bound: FP32 operations (utils/roofline.py's
per-unit counts times the work that the plain version counted on a parity
run of the same scene, scaled to the kernel's own bounce count) and bytes
(inputs once, outputs once) over the H100's peak rates.  No single PyTorch
call computes path radiance, a bounce or a closest hit, so ``library_ms``
is null.

The line before the last is the kernels' JSON record, the line before it
the card's name and power limit; the last line is {"ok": true, "device":
{...}}.  Without CUDA, or without the package next to this script, it
exits nonzero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
W = H = 400
SPP = 1024
DEPTH = 10
GOLDEN = os.path.join(REPO, "tests", "golden", "bench_cornell_regions.json")
SCENE_REGIONS = os.path.join(REPO, "tests", "golden", "scene_regions.json")
KERNEL_SOURCE = "zig_weekend_raytracer_tpu_torch/csrc/fused_render.cu"
KERNEL_REPLACES = "zig_weekend_raytracer_tpu/ops/pallas_bounce.py:1531"
KERNEL_LUT_REPLACES = ("zig_weekend_raytracer_tpu/ops/pallas_bounce.py:1531 "
                       "(_fused_render_kernel), :189 (_texlut_fetch)")
HIT_SOURCE = "zig_weekend_raytracer_tpu_torch/csrc/closest_hit.cu"
HIT_REPLACES = (
    "zig_weekend_raytracer_tpu/ops/pallas_trace.py:300 (_sphere_kernel), "
    ":371 (_quad_kernel), :432 (_tree_kernel)"
)
BOUNCE_SOURCE = "zig_weekend_raytracer_tpu_torch/csrc/bounce.cu"
BOUNCE_REPLACES = "zig_weekend_raytracer_tpu/ops/pallas_bounce.py:842 (_bounce_kernel)"
PLAIN_BUDGET_S = 20.0
SLICE_LANES = 4096
BALLS_SPP = 128
RTW_SPP, RTW_DEPTH = 64, 8
HIT_RTOL, HIT_ATOL, HIT_AGREE = 1e-5, 1e-6, 0.999
LIBRARY_NOTE = "none: no single PyTorch call computes path radiance, a bounce or a closest hit"
# texel budgets of the texture LUT: native holds rtw_final's images
# unpadded (7,151,808 + 87,600 texels), the others box-downsample them
LUT_NATIVE, LUT_32K, LUT_8K = 1 << 23, 32768, 8192
EMISSIVE_SPP = 256
LUT_PAIRS = 10
STAGES = ("scene initialized", "scene rendered", "scene written to file")


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, repeats: int = 1):
    """Best device time of ``fn`` over ``repeats`` runs, by CUDA events,
    and the last run's result."""
    import torch

    best = float("inf")
    out = None
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end))
    return best, out


def compare(tag: str, out_k, out_p) -> dict:
    """The kernel's (radiance, work) against the plain version's: work
    counts equal and radiance within rtol 1e-4 / atol 1e-5 on >= 99% of
    lanes, means within 1e-4 relative.  Returns the counts that differ."""
    import numpy as np

    (rad_k, work_k), (rad_p, work_p) = out_k, out_p
    rk = rad_k.to_array().cpu().numpy()
    rp = rad_p.to_array().cpu().numpy()
    wk = work_k.cpu().numpy()
    wp = work_p.cpu().numpy()
    n = rk.shape[0]
    work_diff = int((wk != wp).sum())
    close = np.isclose(rk, rp, rtol=1e-4, atol=1e-5).all(axis=1)
    rad_diff = int((~close).sum())
    mean_rel = abs(float(rk.mean()) - float(rp.mean())) / max(abs(float(rp.mean())), 1e-12)
    max_abs = float(np.abs(rk - rp).max())
    log(
        f"parity {tag}: {n} lanes, work counts differ on {work_diff}, "
        f"radiance outside rtol 1e-4/atol 1e-5 on {rad_diff}, "
        f"mean rel diff {mean_rel:.3e}, max |diff| {max_abs:.3e}"
    )
    if not np.isfinite(rk).all():
        raise AssertionError(f"parity {tag}: kernel radiance is not finite")
    if work_diff > 0.01 * n or rad_diff > 0.01 * n or mean_rel > 1e-4:
        raise AssertionError(f"parity {tag}: kernel disagrees with its plain version")
    return {"check": tag, "lanes": n, "work_diff": work_diff, "rad_diff": rad_diff,
            "mean_rel": mean_rel, "max_abs_err": max_abs}


@contextlib.contextmanager
def leaf_span(span):
    """ZWRT_LEAF_GROUPS=span while a scene compiles (None: the default)."""
    old = os.environ.pop("ZWRT_LEAF_GROUPS", None)
    if span is not None:
        os.environ["ZWRT_LEAF_GROUPS"] = str(span)
    try:
        yield
    finally:
        os.environ.pop("ZWRT_LEAF_GROUPS", None)
        if old is not None:
            os.environ["ZWRT_LEAF_GROUPS"] = old


def render_parity(zt, fused, integrator, torch, scene, tag, depth=10) -> dict:
    """Kernel vs plain version on the card at 32x32, 8 spp, depth 10 (or
    ``depth``), with the scene's own depth of field; both timed by CUDA
    events."""
    from zig_weekend_raytracer_tpu_torch.render.camera import camera_consts

    w = h = 32
    spp = 8
    ys, xs = torch.meshgrid(
        torch.arange(h, device="cuda"), torch.arange(w, device="cuda"), indexing="ij"
    )
    i32 = torch.int32
    px = xs.reshape(-1).to(i32).contiguous()
    py = ys.reshape(-1).to(i32).contiguous()
    s0 = torch.zeros_like(px)
    s1 = torch.full_like(px, spp)
    kw = dict(
        camera_consts=camera_consts(scene.camera, w, h),
        sampler=zt.sampling.SamplerKind.SOBOL, width=w, height=h, spp=spp,
        stride=1, max_depth=depth, has_dof=scene.camera.has_depth_of_field,
        want_work=True,
    )
    t_min = zt.dtypes.T_MIN
    ms_k, out_k = cuda_time_ms(
        lambda: fused.render_fused(scene.compiled, px, py, s0, s1, 0, t_min, **kw), 3
    )
    ms_p, out_p = cuda_time_ms(
        lambda: integrator.render_fused_reference(scene.compiled, px, py, s0, s1, 0, t_min, **kw)
    )
    check = compare(tag, out_k, out_p)
    log(f"parity {tag}: kernel {ms_k:.3f} ms, plain {ms_p:.1f} ms")
    return {**check, "ms": ms_k, "plain_ms": ms_p}


def camera_rays(zt, torch, scene, w, h, spp):
    """Every pixel's sample-0 camera ray, as the first-hit probe makes it."""
    from zig_weekend_raytracer_tpu_torch.render.camera import (
        camera_consts, camera_params_from_consts, generate_rays,
    )

    ys, xs = torch.meshgrid(
        torch.arange(h, device="cuda"), torch.arange(w, device="cuda"), indexing="ij"
    )
    px, py = xs.reshape(-1), ys.reshape(-1)
    return generate_rays(
        camera_params_from_consts(camera_consts(scene.camera, w, h)),
        scene.camera.has_depth_of_field, zt.sampling.SamplerKind.SOBOL, 0,
        py * w + px, px, py, torch.zeros_like(px), spp, w, h,
    )


def random_scene_rays(zt, torch, n):
    """A seeded random scene of 100 spheres and 600 quads with use_bvh
    (a sphere tree and a multi-node quad tree at the default spans) and n
    random rays with times."""
    import numpy as np

    from zig_weekend_raytracer_tpu_torch.math.v3 import V3

    rng = np.random.default_rng(0)
    b = zt.scene.SceneBuilder()
    mat = b.lambertian(b.solid_color((0.5, 0.5, 0.5)))
    for _ in range(100):
        b.add(b.sphere(rng.uniform(-10, 10, 3), rng.uniform(0.2, 1.5), mat))
    for _ in range(600):
        b.add(b.quad(rng.uniform(-10, 10, 3), rng.uniform(-2, 2, 3), rng.uniform(-2, 2, 3), mat))
    b.use_bvh(True, min_prims=2)
    cs = b.compile(device="cuda").compiled
    cuda = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32), device="cuda")
    org = rng.uniform(-15, 15, (n, 3))
    d = rng.normal(size=(n, 3))
    rays = (V3(*(cuda(org[:, i]) for i in range(3))), V3(*(cuda(d[:, i]) for i in range(3))),
            cuda(rng.uniform(0, 1, n)))
    return cs, rays


def compare_hits(tag: str, hit_k, hit_p) -> dict:
    """(kind, idx) equal on >= 99.9% of rays; t within rtol 1e-5 / atol
    1e-6 where they agree (both inf on an agreed miss)."""
    import numpy as np

    tk, kk, ik = (x.cpu().numpy() for x in hit_k)
    tp, kp, ip = (x.cpu().numpy() for x in hit_p)
    n = kk.size
    agree = (kk == kp) & (ik == ip)
    hit = agree & (kp >= 0)
    t_bad = int((~np.isclose(tk[hit], tp[hit], rtol=HIT_RTOL, atol=HIT_ATOL)).sum())
    miss_bad = int((~(np.isinf(tk) & np.isinf(tp)))[agree & (kp < 0)].sum())
    max_abs = float(np.abs(tk[hit] - tp[hit]).max()) if hit.any() else 0.0
    differ = int(n - agree.sum())
    log(
        f"closest hit {tag}: {n} rays, {int((kp >= 0).sum())} hits, (kind, idx) differ on "
        f"{differ}, t outside rtol {HIT_RTOL}/atol {HIT_ATOL} on {t_bad} agreeing hits, "
        f"miss t not inf on {miss_bad}, max |t diff| {max_abs:.3e}"
    )
    if differ > (1.0 - HIT_AGREE) * n or t_bad or miss_bad:
        raise AssertionError(f"closest hit {tag}: kernel disagrees with its plain version")
    return {"check": tag, "rays": n, "kind_idx_diff": differ, "t_bad": t_bad,
            "max_abs_err": max_abs}


def phase_closest_hit(zt, ch, ttrace, torch) -> list:
    """closest_hit_kernel vs its plain version on the card, four cases."""
    import numpy as np

    from zig_weekend_raytracer_tpu_torch.utils import roofline, workcount

    t_probe = float(np.float32(1e-4))
    cornell = zt.models.load_scene("cornell_box", device="cuda")
    balls = zt.models.load_scene("balls", device="cuda")
    with leaf_span(2):
        balls2 = zt.models.load_scene("balls", device="cuda")
    probe = camera_rays(zt, torch, balls, W, H, BALLS_SPP)
    rand_cs, rand_rays = random_scene_rays(zt, torch, W * H)
    cases = [
        ("a cornell camera rays 400x400", cornell.compiled,
         camera_rays(zt, torch, cornell, W, H, SPP), t_probe),
        ("b balls probe rays 400x400, default span", balls.compiled, probe, t_probe),
        ("c balls probe rays 400x400, span 2", balls2.compiled, probe, t_probe),
        ("d random scene 100 spheres + 600 quads, random rays", rand_cs, rand_rays,
         zt.dtypes.T_MIN),
    ]
    out = []
    for tag, cs, rays, t_min in cases:
        sph = "tree" if cs.has_sph_tree else "brute"
        quad = "tree" if cs.has_quad_tree else ("brute" if cs.n_quads else "none")
        nodes = (cs.sph_tree_box.shape[0], cs.quad_tree_box.shape[0])
        ms_k, hit_k = cuda_time_ms(lambda: ch.closest_hit(cs, *rays, t_min), 3)
        with workcount.counting() as counts:
            ms_p, hit_p = cuda_time_ms(lambda: ttrace.closest_hit(cs, *rays, t_min))
        check = compare_hits(tag, hit_k, hit_p)
        # rays in (origin, direction, time), hits out (t, kind, idx)
        nbytes = rays[2].numel() * (28 + 12) + roofline.trace_bytes(cs)
        bound, by = roofline.bound_ms(roofline.trace_ops(counts), nbytes)
        log(f"closest hit {tag}: spheres {sph}, quads {quad}, tree nodes {nodes}; "
            f"kernel {ms_k:.3f} ms, plain {ms_p:.1f} ms, bound {bound:.4f} ms ({by})")
        out.append({**check, "spheres": sph, "quads": quad, "ms": ms_k, "plain_ms": ms_p,
                    "bound_ms": bound, "bound_by": by})
    return out


def reset_counts(fused, integrator, ch, ttrace, tb) -> None:
    fused.render_fused.launches = 0
    integrator.render_fused_reference.calls = 0
    ch.closest_hit.launches = 0
    ttrace.closest_hit.calls = 0
    tb.bounce.launches = 0
    tb.bounce_regen.launches = 0
    integrator.bounce.calls = 0
    integrator.bounce_regen_reference.calls = 0
    integrator.trace_paths_regen.passes = 0
    integrator.trace_paths_regen.bands = 0


def plain_calls(integrator, ttrace) -> int:
    return (integrator.render_fused_reference.calls + integrator.bounce_regen_reference.calls
            + integrator.bounce.calls + ttrace.closest_hit.calls)


def timed_renders(renderer, scene, torch, w, h):
    """One warmup render and three timed renders; (warmup s, times, fb)."""
    t0 = time.perf_counter()
    renderer.render_device(scene, w, h)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    times = []
    fb = None
    for _ in range(3):
        t0 = time.perf_counter()
        fb = renderer.render_device(scene, w, h)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return warm_s, times, fb


def plan_parity(zt, fused, integrator, scene, plan, spp, card, tag, depth=DEPTH,
                lanes=SLICE_LANES):
    """Kernel vs plain version at a spread slice of ``lanes`` lanes of a
    lane plan, at the full spp and ``depth``; both timed.  Returns the check
    and the plain version's work counts (utils/workcount.py)."""
    from zig_weekend_raytracer_tpu_torch.render.camera import camera_consts
    from zig_weekend_raytracer_tpu_torch.utils import workcount

    step = max(1, plan[0].shape[0] // lanes)
    px, py, s0, _ = (a[::step][:lanes].contiguous() for a in plan)
    kw = dict(
        camera_consts=camera_consts(scene.camera, W, H),
        sampler=zt.sampling.SamplerKind.SOBOL, width=W, height=H, spp=spp,
        stride=1, max_depth=depth, has_dof=scene.camera.has_depth_of_field,
        want_work=True,
    )
    lim = s0 + spp
    t_min = zt.dtypes.T_MIN
    with workcount.counting() as counts:
        ms_p, out_p = cuda_time_ms(
            lambda: integrator.render_fused_reference(scene.compiled, px, py, s0, lim, 0, t_min, **kw)
        )
    ms_k, out_k = cuda_time_ms(
        lambda: fused.render_fused(scene.compiled, px, py, s0, lim, 0, t_min, **kw)
    )
    log(f"plain version at {px.shape[0]} {tag} lanes, {spp} spp: {ms_p:.1f} ms; "
        f"kernel {ms_k:.3f} ms ({card})")
    check = compare(f"{px.shape[0]} {tag} lanes {spp} spp d{depth}", out_k, out_p)
    return {**check, "ms": ms_k, "plain_ms": ms_p}, dict(counts)


def render_bound(zt, scene, counts, kernel_work, lane_bytes, has_dof) -> dict:
    """The roofline bound of a render-kernel run whose lanes did
    ``kernel_work`` bounces in all, from the plain version's ``counts`` on a
    slice scaled by that bounce count; ``lane_bytes`` is what the lanes
    read and write."""
    from zig_weekend_raytracer_tpu_torch.utils import roofline

    factor = float(kernel_work) / max(counts.get("bounce", 0), 1)
    ops = roofline.render_ops(roofline.scaled(counts, factor), scene.compiled, has_dof)
    nbytes = lane_bytes + roofline.render_table_bytes(scene.compiled)
    ms, by = roofline.bound_ms(ops, nbytes)
    log(f"bound: {float(kernel_work):.0f} bounces, {ops:.4g} FP32 operations, {nbytes:.4g} bytes "
        f"-> {ms:.3f} ms ({by})")
    return {"bound_ms": ms, "bound_by": by, "bound_ops": ops, "bound_bytes": nbytes}


def compare_bounce(tag, out_k, out_p) -> dict:
    """One bounce's state, kernel against plain version: alive equal on >=
    99.9% of lanes; where it agrees, throughput and radiance (and, where the
    path goes on, origin and direction) within rtol 1e-5 / atol 1e-6 on >=
    99.9% of lanes."""
    import numpy as np
    import torch

    arr = lambda *vs: torch.stack([c for v in vs for c in v]).cpu().numpy()
    ak, ap = out_k[4].cpu().numpy(), out_p[4].cpu().numpy()
    n = ak.size
    agree = ak == ap
    live = agree & ap
    pos_k, pos_p = arr(*out_k[:2]), arr(*out_p[:2])
    val_k, val_p = arr(*out_k[2:4]), arr(*out_p[2:4])
    pos_bad = live & ~np.isclose(pos_k, pos_p, rtol=HIT_RTOL, atol=HIT_ATOL).all(0)
    val_bad = agree & ~np.isclose(val_k, val_p, rtol=HIT_RTOL, atol=HIT_ATOL).all(0)
    bad = int((pos_bad | val_bad).sum())
    max_abs = max(float(np.abs(pos_k - pos_p)[:, live].max(initial=0.0)),
                  float(np.abs(val_k - val_p)[:, agree].max(initial=0.0)))
    differ = int(n - agree.sum())
    log(f"bounce {tag}: {n} lanes, {int(ap.sum())} go on, alive differs on {differ}, "
        f"state outside rtol {HIT_RTOL}/atol {HIT_ATOL} on {bad}, max |diff| {max_abs:.3e}")
    if not (np.isfinite(val_k).all() and np.isfinite(pos_k[:, ak]).all()):
        raise AssertionError(f"bounce {tag}: kernel state is not finite")
    if differ > (1.0 - HIT_AGREE) * n or bad > (1.0 - HIT_AGREE) * n:
        raise AssertionError(f"bounce {tag}: kernel disagrees with its plain version")
    return {"check": tag, "lanes": n, "alive_diff": differ, "state_bad": bad,
            "max_abs_err": max_abs}


def one_bounce_parity(zt, tb, integrator, torch, scene, name, depths) -> list:
    """bounce_kernel's one-bounce mode vs integrator.bounce on 400x400
    camera rays through the chained ``depths`` (each bounce starts both
    from the plain version's state).  The first bounce also carries its
    roofline bound, from the plain version's work counts: lanes read and
    write 13 float and 2 int state rows."""
    from zig_weekend_raytracer_tpu_torch.math.v3 import V3
    from zig_weekend_raytracer_tpu_torch.utils import roofline, workcount

    t_min = zt.dtypes.T_MIN
    cs = scene.compiled
    ys, xs = torch.meshgrid(torch.arange(H, device="cuda"), torch.arange(W, device="cuda"),
                            indexing="ij")
    rid = (ys * W + xs).reshape(-1)
    o, d, tm = camera_rays(zt, torch, scene, W, H, RTW_SPP)
    n = rid.shape[0]
    state = (o, d, V3.full((n,), 1.0, 1.0, 1.0, "cuda"), V3.zeros((n,), "cuda"),
             torch.ones((n,), dtype=torch.bool, device="cuda"))
    out = []
    for depth in depths:
        o, d, thr, rad, alive = state
        dep = torch.full((n,), depth, dtype=torch.int64, device="cuda")
        ms_k, out_k = cuda_time_ms(
            lambda: tb.bounce(cs, 0, t_min, depth, o, d, tm, rid, thr, rad, alive), 3)
        with workcount.counting() as counts:
            ms_p, out_p = cuda_time_ms(
                lambda: integrator.bounce(cs, 0, t_min, dep, o, d, tm, rid, thr, rad, alive))
        check = compare_bounce(f"{name} 400x400 camera rays, depth {depth}", out_k, out_p)
        bound, by = roofline.bound_ms(roofline.render_ops(dict(counts), cs, False),
                                      n * 15 * 4 * 2 + roofline.render_table_bytes(cs))
        log(f"bounce {name} depth {depth}: kernel {ms_k:.3f} ms, plain {ms_p:.1f} ms, "
            f"bound {bound:.4f} ms ({by})")
        out.append({**check, "ms": ms_k, "plain_ms": ms_p, "bound_ms": bound, "bound_by": by})
        state = out_p
    return out


def phase_one_bounce(zt, tb, integrator, torch, scenes) -> list:
    """bounce_kernel's one-bounce mode vs integrator.bounce: rtw_final
    through three chained bounces, shrek_quads and earth one bounce each."""
    out = []
    for name, depths in (("rtw_final", (0, 1, 2)), ("shrek_quads", (0,)), ("earth", (0,))):
        out += one_bounce_parity(zt, tb, integrator, torch, scenes[name], name, depths)
    return out


def kernel_resources(build_log: str) -> dict:
    """{kernel instantiation: {"registers", "spill_bytes"}} from ptxas -v:
    fused_render_kernel<false> / <true> (without and with the image fetch),
    bounce_kernel<false> / <true> (one-bounce and regenerating modes) and
    closest_hit_kernel."""
    import re

    names = (("fused_render_kernelILb0E", "fused_render_kernel<false>"),
             ("fused_render_kernelILb1E", "fused_render_kernel<true>"),
             ("bounce_kernelILb0E", "bounce_kernel<false>"),
             ("bounce_kernelILb1E", "bounce_kernel<true>"),
             ("closest_hit_kernel", "closest_hit_kernel"))
    out, cur = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = next((v for k, v in names if k in m.group(1)), None)
            if cur:
                out[cur] = {"registers": None, "spill_bytes": None}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            out[cur]["spill_bytes"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
    return out


def emitter_scene(zt, budget):
    """tests/test_texlut.py's image-lamp scene: a quad lamp textured with a
    4x4 checker image over a gray floor, with a LUT of ``budget`` texels
    (0: none)."""
    import numpy as np

    img = np.zeros((4, 4, 3), np.uint8)
    img[::2, ::2] = (200, 40, 40)
    img[1::2, 1::2] = (40, 200, 40)
    b = zt.scene.SceneBuilder()
    m_lamp = b.diffuse_light(b.image_texture(img))
    m_gray = b.lambertian(b.solid_color((0.6, 0.6, 0.6)))
    b.add(b.quad((-4, -1, -4), (8, 0, 0), (0, 0, 8), m_gray))
    b.add(b.quad((-2, 0, -2), (4, 0, 0), (0, 4, 0), m_lamp))
    b.set_background((0.0, 0.0, 0.0))
    b.set_camera(zt.scene.Camera(look_from=(0, 2, 8), look_at=(0, 1, 0)))
    return b.compile(name="image_lamp", device="cuda", texture_lut=budget)


def run_cli(args, timeout=300):
    """The port's CLI as a subprocess from the repository root."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", "zig_weekend_raytracer_tpu_torch.cli", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout,
    )


def cli_render_check(zt, torch, tmp, scene_name, w, spp, depth, lut=0) -> dict:
    """One CLI render with --stats: exit 0, the three stage lines and the
    stats line, and the PPM byte-equal to write_ppm of the same render made
    in this process (a fresh Renderer: the same lanes, and the RNG is
    content-addressed)."""
    import re

    from zig_weekend_raytracer_tpu_torch.io.ppm import write_ppm

    out = os.path.join(tmp, f"{scene_name}.ppm")
    args = [f"--image_width={w}", f"--image_height={w}", f"--samples_per_pixel={spp}",
            f"--ray_bounce_max_depth={depth}", f"--scene={scene_name}",
            f"--image_out_path={out}", "--stats=true"]
    if lut:
        args.append(f"--texture_lut={lut}")
    t0 = time.perf_counter()
    proc = run_cli(args)
    wall = time.perf_counter() - t0
    tag = f"cli {scene_name} {w}x{w} spp{spp} d{depth}" + (f" lut {lut}" if lut else "")
    if proc.returncode != 0:
        raise AssertionError(f"{tag}: exit {proc.returncode}\n{proc.stderr[-2000:]}")
    for stage in STAGES:
        if not re.search(r"^\[\d+\.\d+ ms\]\t" + re.escape(stage) + "$", proc.stderr, re.M):
            raise AssertionError(f"{tag}: no stage line {stage!r}\n{proc.stderr[-2000:]}")
    stats = [ln for ln in proc.stdout.splitlines() if ln.startswith("stats: ")]
    if len(stats) != 1 or "Mpaths/s" not in stats[0]:
        raise AssertionError(f"{tag}: no stats line\n{proc.stdout[-2000:]}")
    scene = zt.models.load_scene(scene_name, device="cuda", texture_lut=lut)
    fb = zt.render.Renderer(samples_per_pixel=spp, max_ray_bounce_depth=depth).render_device(
        scene, w, w)
    ref = os.path.join(tmp, f"{scene_name}.ref.ppm")
    write_ppm(ref, fb.cpu().numpy())
    with open(out, "rb") as f_cli, open(ref, "rb") as f_ref:
        same = f_cli.read() == f_ref.read()
    log(f"{tag}: exit 0 in {wall:.1f} s, {stats[0]!r}; PPM byte-equal to the in-process "
        f"render: {same}")
    if not same:
        raise AssertionError(f"{tag}: the CLI's PPM differs from the in-process render's")
    return {"check": tag, "wall_s": wall, "stats": stats[0]}


def phase_cli(zt, torch) -> list:
    """Phase 16: the CLI as subprocesses."""
    import tempfile

    checks = []
    with tempfile.TemporaryDirectory() as tmp:
        checks.append(cli_render_check(zt, torch, tmp, "emissive", 200, 64, 10))
        checks.append(cli_render_check(zt, torch, tmp, "rtw_final", 128, 16, 10, lut=LUT_32K))
        proc = run_cli(["--image_width=8", "--image_height=8", "--scene=bogus"])
        if proc.returncode != 1 or "Usage: --key=value" not in proc.stderr:
            raise AssertionError(f"cli --scene=bogus: exit {proc.returncode}, no usage text\n"
                                 f"{proc.stderr[-2000:]}")
        log(f"cli --scene=bogus: exit 1, usage on stderr, {proc.stderr.strip().splitlines()[-1]!r}")
        checks.append({"check": "cli --scene=bogus", "exit": 1})
        proc = run_cli(["--image_width=64", "--image_height=64", "--samples_per_pixel=8",
                        "--ray_bounce_max_depth=10", "--scene=cornell_box", "--profile=device",
                        f"--image_out_path={os.path.join(tmp, 'c.ppm')}"])
        rows = [ln for ln in proc.stdout.splitlines() if ln.startswith("fused_render_kernel ")]
        if proc.returncode != 0 or not rows:
            raise AssertionError(f"cli --profile=device: exit {proc.returncode}, no "
                                 f"fused_render_kernel row\n{proc.stdout[-2000:]}\n"
                                 f"{proc.stderr[-2000:]}")
        log("cli --profile=device on cornell 64x64: " + " | ".join(
            ln for ln in proc.stdout.splitlines() if ln.strip() and not ln.startswith("stats")))
        checks.append({"check": "cli --profile=device", "row": rows[0]})
    return checks


def regen_parity(zt, tb, integrator, torch, scene, w, spp, depth, tag, lanes=None):
    """bounce_kernel's regenerating mode vs bounce_regen_reference from
    fresh lanes (every pixel of a w x w image, or ``lanes`` = (px, py) of
    a plan), checked with phase 2's tolerances; every lane must end
    drained.  Returns the check (with both times), the plain version's work
    counts and the kernel's total bounces."""
    from zig_weekend_raytracer_tpu_torch.render.camera import camera_consts
    from zig_weekend_raytracer_tpu_torch.utils import workcount

    if lanes is None:
        ys, xs = torch.meshgrid(torch.arange(w, device="cuda"), torch.arange(w, device="cuda"),
                                indexing="ij")
        lanes = (xs.reshape(-1).to(torch.int32).contiguous(),
                 ys.reshape(-1).to(torch.int32).contiguous())
    px, py = lanes
    s0 = torch.zeros_like(px)
    s1 = torch.full_like(px, spp)
    kw = dict(camera_consts=camera_consts(scene.camera, w, w),
              sampler=zt.sampling.SamplerKind.SOBOL, width=w, height=w, spp=spp, stride=1,
              max_depth=depth, has_dof=scene.camera.has_depth_of_field)
    st0 = integrator.initial_regen_state(s0, 1)
    t_min = zt.dtypes.T_MIN
    ms_k, st_k = cuda_time_ms(
        lambda: tb.bounce_regen(scene.compiled, st0, px, py, s1, 0, t_min, **kw), 3)
    with workcount.counting() as counts:
        ms_p, st_p = cuda_time_ms(
            lambda: integrator.bounce_regen_reference(scene.compiled, st0, px, py, s1, 0, t_min, **kw))
    if bool(st_k.alive.any()) or bool((st_k.sample + 1 < s1).any()):
        raise AssertionError(f"regen {tag}: the kernel left lanes undrained")
    check = compare(tag, (st_k.radiance, st_k.work), (st_p.radiance, st_p.work))
    log(f"regen {tag}: kernel {ms_k:.3f} ms, plain {ms_p:.1f} ms")
    return {**check, "ms": ms_k, "plain_ms": ms_p}, dict(counts), int(st_k.work.sum())


def region_gates(zt, np, scene, name, grid64=8) -> list:
    """The scene's region gates through utils/goldengate.py: 200x200
    against tests/golden/scene_regions.json and 64x64 against
    tests/golden/<name>.npz, each at the spp and depth recorded there; the
    64x64 gate on ``grid64`` x ``grid64`` regions."""
    from zig_weekend_raytracer_tpu_torch.utils.goldengate import check_framebuffer, region_means

    with open(SCENE_REGIONS) as f:
        reg = json.load(f)["scenes"][name]
    fb200 = zt.render.Renderer(
        samples_per_pixel=reg["spp"], max_ray_bounce_depth=reg["depth"]
    ).render_device(scene, reg["width"], reg["height"])
    out = [gate(f"{name} 200x200 spp{reg['spp']} d{reg['depth']}", fb200, reg["mean"],
                reg["region_means"])]
    golden = np.load(os.path.join(REPO, "tests", "golden", f"{name}.npz"))
    fb64 = zt.render.Renderer(
        samples_per_pixel=int(golden["spp"]), max_ray_bounce_depth=int(golden["depth"]),
        seed=int(golden["seed"]),
    ).render_device(scene, int(golden["width"]), int(golden["height"]))
    tag = f"{name} 64x64 spp{int(golden['spp'])} d{int(golden['depth'])}"
    if grid64 != 8:
        fine = check_framebuffer(fb64.cpu().numpy(), float(golden["fb"].mean()),
                                 region_means(golden["fb"], 8))
        log(f"region gate {tag} on 8x8 regions (not gated): {fine}")
        tag += f", {grid64}x{grid64} regions"
    out.append(gate(tag, fb64, golden["fb"].mean(), region_means(golden["fb"], grid64)))
    return out


def gate(tag, fb, ref_mean, ref_regions) -> str:
    import numpy as np

    from zig_weekend_raytracer_tpu_torch.utils.goldengate import check_framebuffer

    fb = fb.cpu().numpy()
    if not np.isfinite(fb).all():
        raise AssertionError(f"{tag}: framebuffer is not finite")
    verdict = check_framebuffer(fb, float(ref_mean), np.asarray(ref_regions))
    log(f"region gate {tag}: {verdict} (mean {fb.mean():.5f} vs {float(ref_mean):.5f})")
    if not verdict.startswith("pass"):
        raise AssertionError(f"region gate {tag} failed: {verdict}")
    return verdict


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        import numpy as np

        import zig_weekend_raytracer_tpu_torch as zt
        from zig_weekend_raytracer_tpu_torch.ops import _build
        from zig_weekend_raytracer_tpu_torch.ops import bounce as tb
        from zig_weekend_raytracer_tpu_torch.ops import closest_hit as ch
        from zig_weekend_raytracer_tpu_torch.ops import fused_render as fused
        from zig_weekend_raytracer_tpu_torch.ops import trace as ttrace
        from zig_weekend_raytracer_tpu_torch.render import integrator
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        return 2
    if "jax" in sys.modules or "zig_weekend_raytracer_tpu" in sys.modules:
        print("chip_smoke: JAX was imported", file=sys.stderr)
        return 1

    # ---- 1. device and build ----
    card = gpu_info()
    kind = torch.cuda.get_device_name(0)
    log(f"gpu: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")
    built = _build.build()
    log(f"kernel build: {built['seconds']:.1f} s (cached={built['cached']})")
    for line in built["log"].splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line or "stack frame" in line:
            log(f"  ptxas: {line.strip()}")
    resources = kernel_resources(built["log"])
    for name, res in resources.items():
        log(f"  {name}: {res['registers']} registers, {res['spill_bytes']} bytes spill stores")
    if len(resources) != 5 or any(r["registers"] is None for r in resources.values()):
        raise AssertionError(f"ptxas did not report every kernel: {resources}")
    _build.load_library()

    # ---- 2. kernel against plain ----
    cornell = zt.models.load_scene("cornell_box", device="cuda")
    checks = [render_parity(zt, fused, integrator, torch, cornell, "cornell 32x32 spp8 d10")]

    # ---- 3. the main path ----
    renderer = zt.render.Renderer(samples_per_pixel=SPP, max_ray_bounce_depth=DEPTH)
    reset_counts(fused, integrator, ch, ttrace, tb)
    warm_s, times, fb = timed_renders(renderer, cornell, torch, W, H)
    launches = fused.render_fused.launches
    n_plain = plain_calls(integrator, ttrace)
    log(f"main path: warmup {warm_s:.3f} s, renders {[round(t, 4) for t in times]} s")
    log(f"main path: kernel launches {launches}, plain-version calls {n_plain}")
    if launches < 1:
        raise AssertionError("the main path launched no kernel")
    if n_plain != 0:
        raise AssertionError("the main path ran the plain version")
    if tuple(fb.shape) != (H, W, 3):
        raise AssertionError(f"bad framebuffer: shape {tuple(fb.shape)}")
    with open(GOLDEN) as f:
        ref = json.load(f)
    verdict = gate("cornell 400x400", fb, ref["mean"], ref["region_means"])
    best = min(times)
    mpaths = W * H * SPP / best / 1e6
    log(
        f"main path best {best:.4f} s = {mpaths:.2f} Mpaths/s "
        f"(cornell {W}x{H}@{SPP} spp d{DEPTH}; {card})"
    )

    # ---- 4. kernel against plain at the main path's lanes ----
    key = (W, H, 0, SPP, DEPTH, renderer.sampler, renderer.seed)
    px, py, s0, s1 = renderer._plan_cache[cornell.compiled][key]["plan"]
    n = px.shape[0]
    from zig_weekend_raytracer_tpu_torch.render.camera import camera_consts

    kw = dict(
        camera_consts=camera_consts(cornell.camera, W, H), sampler=renderer.sampler,
        width=W, height=H, spp=SPP, stride=1, max_depth=DEPTH, has_dof=False,
    )
    t_min = zt.dtypes.T_MIN
    kernel_ms, (_, main_work) = cuda_time_ms(
        lambda: fused.render_fused(cornell.compiled, px, py, s0, s1, 0, t_min,
                                   want_work=True, **kw), 3
    )
    log(f"kernel at main-path lanes ({n} lanes, {SPP} spp): {kernel_ms:.3f} ms")

    def plain(lanes, spp, want_work=False):
        lim = torch.full_like(lanes[3], spp)
        return cuda_time_ms(
            lambda: integrator.render_fused_reference(
                cornell.compiled, *lanes[:3], lim, 0, t_min, want_work=want_work, **kw
            )
        )

    def kernel(lanes, spp, repeats):
        lim = torch.full_like(lanes[3], spp)
        return cuda_time_ms(
            lambda: fused.render_fused(
                cornell.compiled, *lanes[:3], lim, 0, t_min, want_work=True, **kw
            ), repeats,
        )

    plan = (px, py, s0, s1)
    probe_spp = 8
    probe_ms, _ = plain(plan, probe_spp)
    plain_spp = probe_spp
    while plain_spp * 2 <= SPP and probe_ms * (plain_spp * 2) / probe_spp <= PLAIN_BUDGET_S * 1e3:
        plain_spp *= 2
    plain_ms, out_p = plain(plan, plain_spp, want_work=True)
    kernel_ms_same, out_k = kernel(plan, plain_spp, 3)
    log(
        f"plain version at main-path lanes, {plain_spp} spp: {plain_ms:.1f} ms; "
        f"kernel at {plain_spp} spp: {kernel_ms_same:.3f} ms; "
        f"ratio {plain_ms / kernel_ms_same:.1f}x ({card})"
    )
    checks.append(compare(f"main-path lanes {plain_spp} spp d{DEPTH}", out_k, out_p))
    # every sample bit of the main path: a slice spread over the cost-sorted
    # plan, at the full spp (the Sobol scale comes from W and H)
    check, k1_counts = plan_parity(zt, fused, integrator, cornell, plan, SPP, card, "main-path")
    checks.append(check)
    # the timed run's lanes read (px, py, s0, s1) and write radiance and work
    k1_bound = render_bound(zt, cornell, k1_counts, main_work.sum().item(), n * (16 + 16), False)

    # ---- 5. closest-hit kernel against plain ----
    hit_checks = phase_closest_hit(zt, ch, ttrace, torch)

    # ---- 6. render kernel with the tree walk and depth of field ----
    balls = zt.models.load_scene("balls", device="cuda")
    with leaf_span(2):
        balls2 = zt.models.load_scene("balls", device="cuda")
    tree_checks = [
        render_parity(zt, fused, integrator, torch, balls, "balls 32x32 spp8 d10, default span"),
        render_parity(zt, fused, integrator, torch, balls2, "balls 32x32 spp8 d10, span 2"),
    ]

    # ---- 7. the balls main path ----
    b_renderer = zt.render.Renderer(samples_per_pixel=BALLS_SPP, max_ray_bounce_depth=DEPTH)
    reset_counts(fused, integrator, ch, ttrace, tb)
    b_warm_s, b_times, b_fb = timed_renders(b_renderer, balls, torch, W, H)
    b_launches = fused.render_fused.launches
    b_hit_launches = ch.closest_hit.launches
    b_plain = plain_calls(integrator, ttrace)
    plans = b_renderer._plan_cache[balls.compiled]
    coherent = [k for k in plans if k[0] == "coh"]
    log(f"balls main path: warmup {b_warm_s:.3f} s, renders {[round(t, 4) for t in b_times]} s")
    log(f"balls main path: render kernel launches {b_launches}, closest-hit kernel "
        f"launches {b_hit_launches}, plain-version calls {b_plain}, coherent plans "
        f"{len(coherent)}")
    if b_launches < 1 or b_hit_launches < 1:
        raise AssertionError("the balls main path did not launch both kernels")
    if b_plain != 0:
        raise AssertionError("the balls main path ran a plain version")
    if len(coherent) != 1 or len(plans) != 1:
        raise AssertionError("the balls main path did not take the coherent driver")
    if tuple(b_fb.shape) != (H, W, 3) or not bool(torch.isfinite(b_fb).all()):
        raise AssertionError("bad balls framebuffer")
    b_best = min(b_times)
    b_mpaths = W * H * BALLS_SPP / b_best / 1e6
    log(f"balls main path best {b_best:.4f} s = {b_mpaths:.2f} Mpaths/s "
        f"(balls {W}x{H}@{BALLS_SPP} spp d{DEPTH}; {card})")
    b_plan = plans[coherent[0]]["plan"]
    b_kw = dict(
        camera_consts=camera_consts(balls.camera, W, H), sampler=b_renderer.sampler,
        width=W, height=H, spp=BALLS_SPP, stride=1, max_depth=DEPTH, has_dof=True,
    )
    b_kernel_ms, (_, b_work) = cuda_time_ms(
        lambda: fused.render_fused(balls.compiled, *b_plan, 0, t_min, want_work=True, **b_kw), 3
    )
    log(f"kernel at the coherent plan ({b_plan[0].shape[0]} lanes, {BALLS_SPP} spp): "
        f"{b_kernel_ms:.3f} ms ({card})")
    b_slice, b_counts = plan_parity(zt, fused, integrator, balls, b_plan, BALLS_SPP, card,
                                    "coherent-plan")
    tree_checks.append(b_slice)
    k1_tree_bound = render_bound(zt, balls, b_counts, b_work.sum().item(),
                                 b_plan[0].shape[0] * (16 + 12), True)

    # ---- 8. the balls region gates ----
    balls_gates = region_gates(zt, np, balls, "balls")

    # ---- 9. bounce kernel, one-bounce mode, against plain ----
    images = {name: zt.models.load_scene(name, device="cuda")
              for name in ("rtw_final", "shrek_quads", "earth")}
    rtw = images["rtw_final"]
    k2_one = phase_one_bounce(zt, tb, integrator, torch, images)
    k2_checks = []

    # ---- 10. bounce kernel, regenerating mode, against plain ----
    for name, depth in (("earth", 10), ("shrek_quads", 10), ("rtw_final", RTW_DEPTH)):
        tag = f"{name} 32x32 spp8 d{depth}"
        k2_checks.append(regen_parity(zt, tb, integrator, torch, images[name], 32, 8, depth, tag)[0])

    # ---- 11. the rtw_final main path ----
    r_renderer = zt.render.Renderer(samples_per_pixel=RTW_SPP, max_ray_bounce_depth=RTW_DEPTH)
    reset_counts(fused, integrator, ch, ttrace, tb)
    torch.cuda.reset_peak_memory_stats()
    r_warm_s, r_times, r_fb = timed_renders(r_renderer, rtw, torch, W, H)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    r_k2 = tb.bounce_regen.launches + tb.bounce.launches
    r_hit = ch.closest_hit.launches
    r_k1 = fused.render_fused.launches
    r_plain = plain_calls(integrator, ttrace)
    passes, bands = integrator.trace_paths_regen.passes, integrator.trace_paths_regen.bands
    plans = r_renderer._plan_cache[rtw.compiled]
    coherent = [k for k in plans if k[0] == "coh"]
    log(f"rtw_final main path: warmup {r_warm_s:.3f} s, renders {[round(t, 4) for t in r_times]} s")
    log(f"rtw_final main path: bounce kernel launches {r_k2}, closest-hit kernel launches "
        f"{r_hit}, render kernel launches {r_k1}, plain-version calls {r_plain}, coherent "
        f"plans {len(coherent)}; driver loop {passes} passes over {bands} bands "
        f"({passes / max(bands, 1):.2f} per band)")
    if r_k2 < 1 or r_hit < 1:
        raise AssertionError("the rtw_final main path did not launch both kernels")
    if r_k1 != 0 or r_plain != 0:
        raise AssertionError("the rtw_final main path ran the render kernel or a plain version")
    if len(coherent) != 1 or len(plans) != 1:
        raise AssertionError("the rtw_final main path did not take the coherent driver")
    if tuple(r_fb.shape) != (H, W, 3) or not bool(torch.isfinite(r_fb).all()):
        raise AssertionError("bad rtw_final framebuffer")
    r_best = min(r_times)
    r_mpaths = W * H * RTW_SPP / r_best / 1e6
    log(f"rtw_final main path best {r_best:.4f} s = {r_mpaths:.2f} Mpaths/s "
        f"(rtw_final {W}x{H}@{RTW_SPP} spp d{RTW_DEPTH}; {card}); peak device memory "
        f"{peak_mb:.1f} MiB")
    r_plan = plans[coherent[0]]["plan"]
    r_kw = dict(
        camera_consts=camera_consts(rtw.camera, W, H), sampler=r_renderer.sampler, width=W,
        height=H, spp=RTW_SPP, stride=1, max_depth=RTW_DEPTH, has_dof=False,
    )
    st0 = integrator.initial_regen_state(r_plan[2], 1)
    k2_ms, k2_state = cuda_time_ms(
        lambda: tb.bounce_regen(rtw.compiled, st0, r_plan[0], r_plan[1], r_plan[3], 0, t_min,
                                **r_kw), 3)
    log(f"bounce kernel at the coherent plan ({r_plan[0].shape[0]} lanes, {RTW_SPP} spp): "
        f"{k2_ms:.3f} ms ({card})")
    step = max(1, r_plan[0].shape[0] // SLICE_LANES)
    slice_lanes = tuple(a[::step][:SLICE_LANES].contiguous() for a in r_plan[:2])
    k2_slice, k2_counts, _ = regen_parity(
        zt, tb, integrator, torch, rtw, W, RTW_SPP, RTW_DEPTH,
        f"{SLICE_LANES} coherent-plan lanes {RTW_SPP} spp d{RTW_DEPTH}", lanes=slice_lanes)
    k2_checks.append(k2_slice)
    # lanes read 13 float and 5 int state rows and (px, py, limit), and
    # write the 18 state rows
    k2_bound = render_bound(zt, rtw, k2_counts, k2_state.work.sum().item(),
                            r_plan[0].shape[0] * (84 + 72), False)

    # ---- 12. the image scenes' region gates ----
    # rtw_final's 64x64 golden holds 2,048 samples per 8x8-pixel region,
    # too few for its dark regions, whose light comes from rare paths: those
    # decorrelate from the golden's (XLA's contracted multiply-adds; the
    # port equals the JAX integrator run unfused, lane for lane), so its
    # gate takes 4x4 regions of 8,192 samples
    image_gates = {name: region_gates(zt, np, images[name], name,
                                      grid64=4 if name == "rtw_final" else 8)
                   for name in ("earth", "shrek_quads", "rtw_final")}

    # ---- 13. the render kernel with a texture LUT against plain ----
    luts = {f"{name} {budget}": zt.models.load_scene(name, device="cuda", texture_lut=budget)
            for name, budget in (("rtw_final", LUT_NATIVE), ("rtw_final", LUT_32K),
                                 ("shrek_quads", LUT_8K), ("earth", LUT_8K))}
    rtw_lut = luts[f"rtw_final {LUT_NATIVE}"]
    lc = rtw_lut.compiled
    log(f"texture LUT rtw_final at {LUT_NATIVE}: dims {lc.tex_lut_dims}, "
        f"{lc.tex_lut_tab.numel() * 4 / 1e6:.1f} MB; atlas {tuple(lc.atlas_packed.shape)}, "
        f"{lc.atlas_packed.numel() * 4 / 1e6:.1f} MB")
    lut_checks = []
    for tag, scene in luts.items():
        depth = RTW_DEPTH if tag.startswith("rtw_final") else DEPTH
        lut_checks.append(render_parity(zt, fused, integrator, torch, scene,
                                        f"{tag} 32x32 spp8 d{depth}", depth))
    lut_checks.append(render_parity(zt, fused, integrator, torch, emitter_scene(zt, LUT_NATIVE),
                                    f"image lamp, LUT {LUT_NATIVE} 32x32 spp8 d{DEPTH}"))
    k2_checks.append(regen_parity(zt, tb, integrator, torch, emitter_scene(zt, 0), 32, 8, DEPTH,
                                  f"image lamp, atlas 32x32 spp8 d{DEPTH}")[0])
    k2_lut = one_bounce_parity(zt, tb, integrator, torch, rtw_lut, f"rtw_final LUT {LUT_NATIVE}",
                               (0,))

    # ---- 14. the LUT main path ----
    l_renderer = zt.render.Renderer(samples_per_pixel=RTW_SPP, max_ray_bounce_depth=RTW_DEPTH)
    reset_counts(fused, integrator, ch, ttrace, tb)
    torch.cuda.reset_peak_memory_stats()
    l_warm_s, l_times, l_fb = timed_renders(l_renderer, rtw_lut, torch, W, H)
    l_peak_mb = torch.cuda.max_memory_allocated() / 2**20
    l_k1 = fused.render_fused.launches
    l_k2 = tb.bounce_regen.launches + tb.bounce.launches
    l_hit = ch.closest_hit.launches
    l_plain = plain_calls(integrator, ttrace)
    plans = l_renderer._plan_cache[lc]
    coherent = [k for k in plans if k[0] == "coh"]
    log(f"rtw_final LUT main path: warmup {l_warm_s:.3f} s, renders "
        f"{[round(t, 4) for t in l_times]} s")
    log(f"rtw_final LUT main path: render kernel launches {l_k1}, bounce kernel launches "
        f"{l_k2}, closest-hit kernel launches {l_hit}, plain-version calls {l_plain}, "
        f"coherent plans {len(coherent)}")
    if l_k1 != 4 or l_k2 != 0 or l_plain != 0 or l_hit < 1:
        raise AssertionError("the LUT main path did not run the render kernel alone "
                             "(4 launches, no bounce kernel, no plain version)")
    if len(coherent) != 1 or len(plans) != 1:
        raise AssertionError("the LUT main path did not take the coherent driver")
    if tuple(l_fb.shape) != (H, W, 3) or not bool(torch.isfinite(l_fb).all()):
        raise AssertionError("bad rtw_final LUT framebuffer")
    l_best = min(l_times)
    l_mpaths = W * H * RTW_SPP / l_best / 1e6
    l_close = torch.isclose(l_fb, r_fb, rtol=1e-5, atol=1e-6).all(-1).float().mean().item()
    l_vs_atlas = (l_fb - r_fb).abs().max().item()
    log(f"rtw_final LUT main path best {l_best:.4f} s = {l_mpaths:.2f} Mpaths/s (atlas, bounce "
        f"kernel: {r_mpaths:.2f}; {card}); peak device memory {l_peak_mb:.1f} MiB; against "
        f"the atlas render: {l_close:.4%} of pixels within rtol 1e-5/atol 1e-6, "
        f"max |diff| {l_vs_atlas:.3e}")
    if l_close < 0.999:
        raise AssertionError("the LUT render disagrees with the atlas render")
    l_plan = plans[coherent[0]]["plan"]
    l_kernel_ms, (_, l_work) = cuda_time_ms(
        lambda: fused.render_fused(lc, *l_plan, 0, t_min, want_work=True, **r_kw), 3)
    log(f"render kernel with the LUT at the coherent plan ({l_plan[0].shape[0]} lanes, "
        f"{RTW_SPP} spp): {l_kernel_ms:.3f} ms; bounce kernel with the atlas: {k2_ms:.3f} ms "
        f"({card})")
    # Does the LUT, which fits the 50 MB L2, make the image path cheaper
    # than the atlas, which does not?  One best-of-3 pair is within the
    # run-to-run spread, so time both kernels on the same lanes in
    # alternating pairs.
    time_k1 = lambda: cuda_time_ms(
        lambda: fused.render_fused(lc, *l_plan, 0, t_min, **r_kw))[0]
    time_k2 = lambda: cuda_time_ms(
        lambda: tb.bounce_regen(rtw.compiled, st0, r_plan[0], r_plan[1], r_plan[3], 0, t_min,
                                **r_kw))[0]
    lut_same_lanes = all(torch.equal(a, b) for a, b in zip(l_plan, r_plan))
    lut_pairs = []
    for i in range(LUT_PAIRS):
        if i % 2:
            t2 = time_k2()
            lut_pairs.append((time_k1(), t2))
        else:
            lut_pairs.append((time_k1(), time_k2()))
    lut_wins = sum(t1 < t2 for t1, t2 in lut_pairs)
    lut_med = [sorted(ts)[LUT_PAIRS // 2] for ts in zip(*lut_pairs)]
    log(f"render kernel with the LUT vs bounce kernel with the atlas, same lanes, {LUT_PAIRS} "
        f"alternating pairs (same lanes: {lut_same_lanes}): LUT faster in {lut_wins}; medians {lut_med[0]:.3f} vs "
        f"{lut_med[1]:.3f} ms; pairs {[(round(a, 3), round(b, 3)) for a, b in lut_pairs]} "
        f"({card})")
    # half phase 11's slice: the LUT render equals the atlas render already
    l_slice, l_counts = plan_parity(zt, fused, integrator, rtw_lut, l_plan, RTW_SPP, card,
                                    "LUT coherent-plan", depth=RTW_DEPTH,
                                    lanes=SLICE_LANES // 2)
    lut_checks.append(l_slice)
    k1_lut_bound = render_bound(zt, rtw_lut, l_counts, l_work.sum().item(),
                                l_plan[0].shape[0] * (16 + 16), False)
    lut_gates = region_gates(zt, np, rtw_lut, "rtw_final", grid64=4)
    s_renderer = zt.render.Renderer(samples_per_pixel=RTW_SPP, max_ray_bounce_depth=RTW_DEPTH)
    _, s_times, s_fb = timed_renders(s_renderer, luts[f"rtw_final {LUT_32K}"], torch, W, H)
    s_mpaths = W * H * RTW_SPP / min(s_times) / 1e6
    s_diff = (s_fb - l_fb).abs().mean().item()
    log(f"rtw_final LUT {LUT_32K} texels: best {min(s_times):.4f} s = {s_mpaths:.2f} Mpaths/s; "
        f"mean |diff| to the native-budget render {s_diff:.4e} (not gated; {card})")

    # ---- 15. emissive ----
    emissive = zt.models.load_scene("emissive", device="cuda")
    checks.append(render_parity(zt, fused, integrator, torch, emissive, "emissive 32x32 spp8 d10"))
    e_renderer = zt.render.Renderer(samples_per_pixel=EMISSIVE_SPP, max_ray_bounce_depth=DEPTH)
    reset_counts(fused, integrator, ch, ttrace, tb)
    e_warm_s, e_times, e_fb = timed_renders(e_renderer, emissive, torch, W, H)
    e_k1 = fused.render_fused.launches
    e_other = tb.bounce.launches + tb.bounce_regen.launches + ch.closest_hit.launches
    e_plain = plain_calls(integrator, ttrace)
    log(f"emissive main path: warmup {e_warm_s:.3f} s, renders {[round(t, 4) for t in e_times]} "
        f"s; render kernel launches {e_k1}, other kernels {e_other}, plain-version calls "
        f"{e_plain}")
    if e_k1 < 1 or e_other or e_plain:
        raise AssertionError("the emissive main path did not run the render kernel alone")
    if tuple(e_fb.shape) != (H, W, 3) or not bool(torch.isfinite(e_fb).all()):
        raise AssertionError("bad emissive framebuffer")
    e_best = min(e_times)
    e_mpaths = W * H * EMISSIVE_SPP / e_best / 1e6
    log(f"emissive main path best {e_best:.4f} s = {e_mpaths:.2f} Mpaths/s "
        f"(emissive {W}x{H}@{EMISSIVE_SPP} spp d{DEPTH}; {card})")
    emissive_gates = region_gates(zt, np, emissive, "emissive")

    # ---- 16. the CLI ----
    cli_checks = phase_cli(zt, torch)

    b_hit = hit_checks[1]
    k2_first = k2_one[0]
    k2_lut_first = k2_lut[0]
    bound_of = lambda c: {"bound_ms": c["bound_ms"], "bound_by": c["bound_by"]}

    def entry(name, source, replaces, res, launches, by_path, parity, ms, plain_ms, bound,
              tolerance, **extra):
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "launches_by_path": by_path,
            "max_abs_err": max(c["max_abs_err"] for c in parity),
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            **{k: v for k, v in bound.items() if k not in ("bound_ms", "bound_by")},
            "library_ms": None, "library_note": LIBRARY_NOTE,
            "registers": resources[res]["registers"],
            "spill_bytes": resources[res]["spill_bytes"],
            "parity": parity, "tolerance": tolerance, "card": card, **extra,
        }

    render_tol = "rtol 1e-4, atol 1e-5 on >= 99% of lanes; mean 1e-4 rel"
    bounce_tol = "alive equal and state rtol 1e-5, atol 1e-6 on >= 99.9% of lanes"
    record = {"kernels": [
        entry("fused_render_kernel (brute)", KERNEL_SOURCE, KERNEL_REPLACES,
              "fused_render_kernel<false>", launches + e_k1,
              {"cornell": launches, "emissive": e_k1}, checks, kernel_ms, plain_ms, k1_bound,
              render_tol, plain_spp=plain_spp, kernel_ms_at_plain_spp=kernel_ms_same,
              render_s_best=best, mpaths_per_s=mpaths, region_gate=verdict,
              emissive_render_s_best=e_best, emissive_mpaths_per_s=e_mpaths,
              emissive_region_gates=emissive_gates),
        entry("fused_render_kernel (tree)", KERNEL_SOURCE, KERNEL_REPLACES,
              "fused_render_kernel<false>", b_launches, {"balls": b_launches}, tree_checks,
              b_kernel_ms, b_slice["plain_ms"], k1_tree_bound, render_tol,
              plain_lanes=SLICE_LANES, kernel_ms_at_plain_lanes=b_slice["ms"],
              balls_render_s_best=b_best, balls_mpaths_per_s=b_mpaths,
              balls_region_gates=balls_gates),
        entry("fused_render_kernel (texture LUT)", KERNEL_SOURCE, KERNEL_LUT_REPLACES,
              "fused_render_kernel<true>", l_k1, {"rtw_final LUT": l_k1}, lut_checks,
              l_kernel_ms, l_slice["plain_ms"], k1_lut_bound, render_tol,
              plain_lanes=SLICE_LANES // 2, kernel_ms_at_plain_lanes=l_slice["ms"],
              rtw_final_render_s_best=l_best, rtw_final_mpaths_per_s=l_mpaths,
              rtw_final_peak_mib=l_peak_mb, atlas_render_agree=l_close,
              atlas_render_max_abs_diff=l_vs_atlas, region_gates=lut_gates,
              lut_32k_mpaths_per_s=s_mpaths, lut_32k_mean_abs_diff=s_diff,
              lut_vs_atlas_pairs_ms=lut_pairs, lut_vs_atlas_same_lanes=lut_same_lanes),
        entry("bounce_kernel (one bounce)", BOUNCE_SOURCE, BOUNCE_REPLACES, "bounce_kernel<false>",
              0, {}, k2_one, k2_first["ms"], k2_first["plain_ms"], bound_of(k2_first), bounce_tol,
              note="parity only: no main path runs the one-bounce mode; times and bound "
                   "are rtw_final's first bounce at 160,000 lanes"),
        entry("bounce_kernel (one bounce, texture LUT)", BOUNCE_SOURCE, BOUNCE_REPLACES,
              "bounce_kernel<false>", 0, {}, k2_lut, k2_lut_first["ms"],
              k2_lut_first["plain_ms"], bound_of(k2_lut_first), bounce_tol,
              note="parity only: no main path runs the one-bounce mode"),
        entry("bounce_kernel (regenerating)", BOUNCE_SOURCE, BOUNCE_REPLACES,
              "bounce_kernel<true>", r_k2, {"rtw_final": r_k2}, k2_checks, k2_ms,
              k2_slice["plain_ms"], k2_bound, render_tol, plain_lanes=SLICE_LANES,
              kernel_ms_at_plain_lanes=k2_slice["ms"],
              driver_passes_per_band=passes / max(bands, 1), rtw_final_render_s_best=r_best,
              rtw_final_mpaths_per_s=r_mpaths, rtw_final_peak_mib=peak_mb,
              region_gates=image_gates),
        entry("closest_hit_kernel", HIT_SOURCE, HIT_REPLACES, "closest_hit_kernel",
              b_hit_launches + r_hit + l_hit,
              {"balls": b_hit_launches, "rtw_final": r_hit, "rtw_final LUT": l_hit}, hit_checks,
              b_hit["ms"], b_hit["plain_ms"], bound_of(b_hit),
              f"(kind, idx) equal on >= {HIT_AGREE:.1%} of rays; t rtol {HIT_RTOL}, "
              f"atol {HIT_ATOL}"),
    ], "cli": cli_checks}
    print(card, flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
