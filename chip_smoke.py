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
     and 64x64, 32 spp, depth 10 against tests/golden/balls.npz.

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
BALLS_GOLDEN = os.path.join(REPO, "tests", "golden", "balls.npz")
KERNEL_SOURCE = "zig_weekend_raytracer_tpu_torch/csrc/fused_render.cu"
KERNEL_REPLACES = "zig_weekend_raytracer_tpu/ops/pallas_bounce.py:1531"
HIT_SOURCE = "zig_weekend_raytracer_tpu_torch/csrc/closest_hit.cu"
HIT_REPLACES = (
    "zig_weekend_raytracer_tpu/ops/pallas_trace.py:300 (_sphere_kernel), "
    ":371 (_quad_kernel), :432 (_tree_kernel)"
)
PLAIN_BUDGET_S = 20.0
SLICE_LANES = 4096
BALLS_SPP = 128
HIT_RTOL, HIT_ATOL, HIT_AGREE = 1e-5, 1e-6, 0.999


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


def render_parity(zt, fused, integrator, torch, scene, tag) -> dict:
    """Kernel vs plain version on the card at 32x32, 8 spp, depth 10, with
    the scene's own depth of field; both timed by CUDA events."""
    from zig_weekend_raytracer_tpu_torch.render.camera import camera_consts

    w = h = 32
    spp, depth = 8, 10
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
        ms_p, hit_p = cuda_time_ms(lambda: ttrace.closest_hit(cs, *rays, t_min))
        check = compare_hits(tag, hit_k, hit_p)
        log(f"closest hit {tag}: spheres {sph}, quads {quad}, tree nodes {nodes}; "
            f"kernel {ms_k:.3f} ms, plain {ms_p:.1f} ms")
        out.append({**check, "spheres": sph, "quads": quad, "ms": ms_k, "plain_ms": ms_p})
    return out


def reset_counts(fused, integrator, ch, ttrace) -> None:
    fused.render_fused.launches = 0
    integrator.render_fused_reference.calls = 0
    ch.closest_hit.launches = 0
    ttrace.closest_hit.calls = 0


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


def plan_parity(zt, fused, integrator, scene, plan, spp, card, tag) -> dict:
    """Kernel vs plain version at a spread slice of SLICE_LANES lanes of a
    lane plan, at the full spp; both timed."""
    from zig_weekend_raytracer_tpu_torch.render.camera import camera_consts

    step = max(1, plan[0].shape[0] // SLICE_LANES)
    px, py, s0, _ = (a[::step][:SLICE_LANES].contiguous() for a in plan)
    kw = dict(
        camera_consts=camera_consts(scene.camera, W, H),
        sampler=zt.sampling.SamplerKind.SOBOL, width=W, height=H, spp=spp,
        stride=1, max_depth=DEPTH, has_dof=scene.camera.has_depth_of_field,
        want_work=True,
    )
    lim = s0 + spp
    t_min = zt.dtypes.T_MIN
    ms_p, out_p = cuda_time_ms(
        lambda: integrator.render_fused_reference(scene.compiled, px, py, s0, lim, 0, t_min, **kw)
    )
    ms_k, out_k = cuda_time_ms(
        lambda: fused.render_fused(scene.compiled, px, py, s0, lim, 0, t_min, **kw)
    )
    log(f"plain version at {px.shape[0]} {tag} lanes, {spp} spp: {ms_p:.1f} ms; "
        f"kernel {ms_k:.3f} ms ({card})")
    return {**compare(f"{px.shape[0]} {tag} lanes {spp} spp d{DEPTH}", out_k, out_p),
            "ms": ms_k, "plain_ms": ms_p}


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
        from zig_weekend_raytracer_tpu_torch.ops import closest_hit as ch
        from zig_weekend_raytracer_tpu_torch.ops import fused_render as fused
        from zig_weekend_raytracer_tpu_torch.ops import trace as ttrace
        from zig_weekend_raytracer_tpu_torch.render import integrator
        from zig_weekend_raytracer_tpu_torch.utils.goldengate import region_means
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
    _build.load_library()

    # ---- 2. kernel against plain ----
    cornell = zt.models.load_scene("cornell_box", device="cuda")
    checks = [render_parity(zt, fused, integrator, torch, cornell, "cornell 32x32 spp8 d10")]

    # ---- 3. the main path ----
    renderer = zt.render.Renderer(samples_per_pixel=SPP, max_ray_bounce_depth=DEPTH)
    reset_counts(fused, integrator, ch, ttrace)
    warm_s, times, fb = timed_renders(renderer, cornell, torch, W, H)
    launches = fused.render_fused.launches
    plain_calls = integrator.render_fused_reference.calls + ttrace.closest_hit.calls
    log(f"main path: warmup {warm_s:.3f} s, renders {[round(t, 4) for t in times]} s")
    log(f"main path: kernel launches {launches}, plain-version calls {plain_calls}")
    if launches < 1:
        raise AssertionError("the main path launched no kernel")
    if plain_calls != 0:
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
    kernel_ms, _ = cuda_time_ms(
        lambda: fused.render_fused(cornell.compiled, px, py, s0, s1, 0, t_min, **kw), 3
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
    checks.append(plan_parity(zt, fused, integrator, cornell, plan, SPP, card, "main-path"))

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
    reset_counts(fused, integrator, ch, ttrace)
    b_warm_s, b_times, b_fb = timed_renders(b_renderer, balls, torch, W, H)
    b_launches = fused.render_fused.launches
    b_hit_launches = ch.closest_hit.launches
    b_plain = integrator.render_fused_reference.calls + ttrace.closest_hit.calls
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
    b_kernel_ms, _ = cuda_time_ms(
        lambda: fused.render_fused(balls.compiled, *b_plan, 0, t_min, **b_kw), 3
    )
    log(f"kernel at the coherent plan ({b_plan[0].shape[0]} lanes, {BALLS_SPP} spp): "
        f"{b_kernel_ms:.3f} ms ({card})")
    tree_checks.append(
        plan_parity(zt, fused, integrator, balls, b_plan, BALLS_SPP, card, "coherent-plan")
    )

    # ---- 8. the balls region gates ----
    with open(SCENE_REGIONS) as f:
        reg = json.load(f)["scenes"]["balls"]
    fb200 = zt.render.Renderer(
        samples_per_pixel=reg["spp"], max_ray_bounce_depth=reg["depth"]
    ).render_device(balls, reg["width"], reg["height"])
    v200 = gate("balls 200x200 spp32 d10", fb200, reg["mean"], reg["region_means"])
    golden = np.load(BALLS_GOLDEN)
    fb64 = zt.render.Renderer(
        samples_per_pixel=int(golden["spp"]), max_ray_bounce_depth=int(golden["depth"]),
        seed=int(golden["seed"]),
    ).render_device(balls, int(golden["width"]), int(golden["height"]))
    v64 = gate("balls 64x64 spp32 d10", fb64, golden["fb"].mean(), region_means(golden["fb"], 8))

    b_hit = hit_checks[1]
    record = {"kernels": [
        {
            "name": "fused_render_kernel",
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": KERNEL_REPLACES,
            "launches": launches + b_launches,
            "launches_by_path": {"cornell": launches, "balls": b_launches},
            "max_abs_err": max(c["max_abs_err"] for c in checks + tree_checks),
            "ms": kernel_ms,
            "plain_ms": plain_ms,
            "plain_spp": plain_spp,
            "kernel_ms_at_plain_spp": kernel_ms_same,
            "balls_ms": b_kernel_ms,
            "parity": checks + tree_checks,
            "tolerance": "rtol 1e-4, atol 1e-5 on >= 99% of lanes; mean 1e-4 rel",
            "render_s_best": best,
            "mpaths_per_s": mpaths,
            "region_gate": verdict,
            "balls_render_s_best": b_best,
            "balls_mpaths_per_s": b_mpaths,
            "balls_region_gates": [v200, v64],
            "card": card,
        },
        {
            "name": "closest_hit_kernel",
            "route": "cuda",
            "source": HIT_SOURCE,
            "replaces": HIT_REPLACES,
            "launches": b_hit_launches,
            "max_abs_err": max(c["max_abs_err"] for c in hit_checks),
            "ms": b_hit["ms"],
            "plain_ms": b_hit["plain_ms"],
            "parity": hit_checks,
            "tolerance": f"(kind, idx) equal on >= {HIT_AGREE:.1%} of rays; "
                         f"t rtol {HIT_RTOL}, atol {HIT_ATOL}",
            "card": card,
        },
    ]}
    print(card, flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
