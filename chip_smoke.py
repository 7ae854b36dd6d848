#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Phases (any failure exits nonzero):
  1. device: the card's name and power limit, then the kernel build from
     zig_weekend_raytracer_tpu_torch/csrc/ (seconds, registers, spills of
     every instantiation); the default walk's instantiations must keep the
     previous slice's registers and spill (DEFAULT_RESOURCES);
 1b. the FP32 peak (tools/fp32_peak.py, kernel K5): chain_kernel against
     its plain version on the card for the four ops at every (blocks per
     SM, chains, unroll) of the sweep, on the sweep's own grid with 256
     steps (rtol 1e-6), the fma chain's SASS (FFMA, not FMUL + FADD), then
     the sweep with its iters-scaling check (4x / 1x time ratio in [3, 5])
     and the physics bound (no rate past 105%); the measured add rate, in
     lane-operations per second, is the rate every later bound divides by;
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
     to finish in about 20 s, beside the kernel at the same spp (its work
     counts give the bound); both on a spread slice of 4,096 of those
     lanes, each rendering one 64-sample window of the 1024, the windows
     together covering every sample index (every Sobol sample bit); and
     both on a spread slice of 1,024 lanes, each draining all 1024 samples
     of its pixel as the main path's lanes do, at depth 2 (the plain
     version's time grows with its loop passes: 226 s at depth 10 on an
     H100); all outputs held to the tolerances of phase 2, both times
     printed;
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
     device table that names fused_render_kernel;
 17. the tree walks (kernel K4: ZWRT_TRAV=queue|rowqueue|spec, and the
     unified tree of ZWRT_UNI_TREE=1) against their plain versions, with
     the tolerances of phases 2 and 9: for each walk the render kernel on
     balls at leaf span 2, 32x32, 4 spp, depth 10 (not under uni: balls has
     no quads), the bounce kernel's regenerating mode on rtw_final 32x32, 4
     spp, depth 8 and its one-bounce mode on rtw_final's 160,000 camera
     rays, all of them live and with every other lane dead (the warp's
     lanes diverge at the trace), and under uni the render kernel with a
     native-budget LUT on rtw_final; each walk's plain version against the
     default walk's plain version on the same inputs;
 18. the walks on the slice's path at full width, each with its counts set
     to 0 just before and read just after: Renderer(samples_per_pixel=64,
     max_ray_bounce_depth=8).render_device of rtw_final at 400x400 under
     each of queue, rowqueue and spec (bounce kernel) and compiled with the
     unified tree through the bounce kernel and through the render kernel
     with the LUT; balls 400x400@128 d10 at leaf span 2 under the default
     walk and each of queue, rowqueue and spec (render kernel); one warmup
     and three timed renders each, Mpaths/s, the walk's instantiation
     launched and nothing else of the kind, no plain version, the kernel's
     time at the plan's lanes, each framebuffer within rtol 1e-5 / atol 1e-6
     of the default walk's render of the same scene on >= 99.9% of pixels,
     and rtw_final's region gates of phase 12 on the unified-tree render.

The record has one entry per kernel and mode: the render kernel on brute
scenes (cornell, emissive), on tree scenes (balls) and with the texture LUT
(rtw_final), the bounce kernel's one-bounce mode with the atlas and with
the LUT (parity checks only: no main path runs it, so its launches are 0)
and its regenerating mode (rtw_final), and the closest-hit kernel; then one
per walk of the render kernel (queue, rowqueue and spec on balls at span 2,
uni with the LUT on rtw_final) and of the bounce kernel's regenerating mode
(rtw_final), and the FP32-peak chain kernel.  Each carries its registers
and spill from the build, its times, its launches on its path and its
roofline bound: FP32 lane-operations (utils/roofline.py's per-unit counts
times the work that the plain version counted on a parity run of the same
scene, scaled to the kernel's own bounce count) over phase 1b's measured
add rate (``peak_source``), and bytes (inputs once, outputs once) over the
H100's HBM3 rate.  No single PyTorch call computes path radiance, a bounce,
a closest hit or an operation chain, so ``library_ms`` is null.

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
# phase 4's full drain: each lane of the slice renders all 1024 samples of
# its pixel as the main path's lanes do; the plain version's time grows
# with its loop passes, not its lanes (about 4.5 passes per sample at
# depth 10: 226 s on an H100), so the slice runs at a cut depth
FULL_DRAIN_LANES, FULL_DRAIN_DEPTH = 1024, 2
# phase 17's parity renders: 32x32 at this spp
WALK_SPP = 4
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
PEAK_SOURCE = "zig_weekend_raytracer_tpu_torch/csrc/fp32_peak.cu"
PEAK_REPLACES = "tools/vpu_peak.py:59 (_chain_kernel; pallas_call :123 in build :119)"
WALK_REPLACES = {
    "queue": "zig_weekend_raytracer_tpu/ops/pallas_bounce.py:466 (_tree_pass_queue, per_row=False)",
    "rowqueue": "zig_weekend_raytracer_tpu/ops/pallas_bounce.py:466 (_tree_pass_queue, per_row=True)",
    "spec": "zig_weekend_raytracer_tpu/ops/pallas_bounce.py:640 (_tree_pass_spec)",
    "uni": "zig_weekend_raytracer_tpu/ops/pallas_bounce.py:713 (_uni_tree_pass)",
}
NEW_WALKS = ("queue", "rowqueue", "spec", "uni")
# a chain kernel's plain version against it: the plain fma is float64
# arithmetic rounded once to float32, which can differ from fmaf by one ulp
CHAIN_RTOL = 1e-6
# iters x unroll of each parity run: the sweep's own instantiations and
# grids, with iters cut so that the plain version stays short
CHAIN_STEPS = 256
# registers and spill of the default instantiations in the previous slice
DEFAULT_RESOURCES = {
    "fused_render_kernel<false, cond>": (64, 32), "fused_render_kernel<true, cond>": (64, 28),
    "bounce_kernel<false, cond>": (64, 0), "bounce_kernel<true, cond>": (64, 12),
    "closest_hit_kernel": (56, 0),
}
# the measured add rate (lane-operations per second) every bound divides by
# once phase 1b has run
OPS_RATE = {"rate": None}


def log(msg: str) -> None:
    print(msg, flush=True)


START = time.perf_counter()


def phase(name: str) -> None:
    """Mark the start of a phase with the script's elapsed time."""
    log(f"==== phase {name} at {time.perf_counter() - START:.1f} s")


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
def env(name, value):
    """``name`` set to ``value`` (None: unset) for the block."""
    old = os.environ.pop(name, None)
    if value is not None:
        os.environ[name] = value
    try:
        yield
    finally:
        os.environ.pop(name, None)
        if old is not None:
            os.environ[name] = old


def leaf_span(span):
    """ZWRT_LEAF_GROUPS=span while a scene compiles (None: the default)."""
    return env("ZWRT_LEAF_GROUPS", None if span is None else str(span))


def trav(walk):
    """ZWRT_TRAV for ``walk`` while the kernels launch; the default walk and
    the unified tree (a property of the scene) leave it unset."""
    return env("ZWRT_TRAV", walk if walk in ("queue", "rowqueue", "spec") else None)


def render_parity(zt, fused, integrator, torch, scene, tag, depth=10, plains=None,
                  spp=8) -> dict:
    """Kernel vs plain version on the card at 32x32, ``spp`` spp, depth 10
    (or ``depth``), with the scene's own depth of field; both timed by CUDA
    events.  ``plains``, a list, collects the plain version's output and
    its work counts."""
    from zig_weekend_raytracer_tpu_torch.render.camera import camera_consts
    from zig_weekend_raytracer_tpu_torch.utils import workcount

    w = h = 32
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
    with workcount.counting() if plains is not None else contextlib.nullcontext({}) as counts:
        ms_p, out_p = cuda_time_ms(
            lambda: integrator.render_fused_reference(scene.compiled, px, py, s0, s1, 0, t_min, **kw)
        )
    check = compare(tag, out_k, out_p)
    log(f"parity {tag}: kernel {ms_k:.3f} ms, plain {ms_p:.1f} ms")
    if plains is not None:
        plains.append((out_p, dict(counts)))
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
        bound, by = roofline.bound_ms(roofline.trace_ops(counts), nbytes, OPS_RATE["rate"])
        log(f"closest hit {tag}: spheres {sph}, quads {quad}, tree nodes {nodes}; "
            f"kernel {ms_k:.3f} ms, plain {ms_p:.1f} ms, bound {bound:.4f} ms ({by})")
        out.append({**check, "spheres": sph, "quads": quad, "ms": ms_k, "plain_ms": ms_p,
                    "bound_ms": bound, "bound_by": by,
                    "peak_source": roofline.peak_source(OPS_RATE["rate"])})
    return out


def reset_counts(fused, integrator, ch, ttrace, tb) -> None:
    integrator.render_fused_reference.calls = 0
    ch.closest_hit.launches = 0
    ttrace.closest_hit.calls = 0
    integrator.bounce.calls = 0
    integrator.bounce_regen_reference.calls = 0
    integrator.trace_paths_regen.passes = 0
    integrator.trace_paths_regen.bands = 0
    for host in (fused.render_fused, tb.bounce, tb.bounce_regen):
        host.launches = dict.fromkeys(host.launches, 0)


def launched(host) -> int:
    """The launches of a render or bounce kernel wrapper, over every walk."""
    return sum(host.launches.values())


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
                lanes=SLICE_LANES, window=None):
    """Kernel vs plain version at a spread slice of ``lanes`` lanes of a
    lane plan, at the full spp and ``depth``; both timed.  With ``window``
    each lane renders only one ``window``-sample window of the spp samples,
    lane i the (i mod spp / window)-th, so that the slice covers every
    sample index (every Sobol sample bit) in a window's drain passes.
    Returns the check and the plain version's work counts
    (utils/workcount.py)."""
    import torch

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
    if window:
        lane = torch.arange(s0.shape[0], dtype=s0.dtype, device=s0.device)
        s0 = (s0 + lane % (spp // window) * window).contiguous()
        lim = s0 + window
        tag = f"{tag} lanes, {spp} spp in {window}-sample windows"
    else:
        tag = f"{tag} lanes, {spp} spp"
    t_min = zt.dtypes.T_MIN
    with workcount.counting() as counts:
        ms_p, out_p = cuda_time_ms(
            lambda: integrator.render_fused_reference(scene.compiled, px, py, s0, lim, 0, t_min, **kw)
        )
    ms_k, out_k = cuda_time_ms(
        lambda: fused.render_fused(scene.compiled, px, py, s0, lim, 0, t_min, **kw)
    )
    log(f"plain version at {px.shape[0]} {tag}: {ms_p:.1f} ms; kernel {ms_k:.3f} ms ({card})")
    check = compare(f"{px.shape[0]} {tag} d{depth}", out_k, out_p)
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
    ms, by = roofline.bound_ms(ops, nbytes, OPS_RATE["rate"])
    source = roofline.peak_source(OPS_RATE["rate"])
    log(f"bound: {float(kernel_work):.0f} bounces, {ops:.4g} FP32 operations, {nbytes:.4g} bytes "
        f"-> {ms:.3f} ms ({by}, {source} rate)")
    return {"bound_ms": ms, "bound_by": by, "bound_ops": ops, "bound_bytes": nbytes,
            "peak_source": source}


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


def one_bounce_parity(zt, tb, integrator, torch, scene, name, depths, plains=None,
                      alive0=None) -> list:
    """bounce_kernel's one-bounce mode vs integrator.bounce on 400x400
    camera rays through the chained ``depths`` (each bounce starts both
    from the plain version's state), every lane live at first or those of
    the mask ``alive0``.  The first bounce also carries its roofline bound,
    from the plain version's work counts: lanes read and write 13 float and
    2 int state rows.  ``plains``, a list, collects the plain version's
    outputs."""
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
             torch.ones((n,), dtype=torch.bool, device="cuda") if alive0 is None else alive0)
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
                                      n * 15 * 4 * 2 + roofline.render_table_bytes(cs),
                                      OPS_RATE["rate"])
        log(f"bounce {name} depth {depth}: kernel {ms_k:.3f} ms, plain {ms_p:.1f} ms, "
            f"bound {bound:.4f} ms ({by})")
        out.append({**check, "ms": ms_k, "plain_ms": ms_p, "bound_ms": bound, "bound_by": by,
                    "peak_source": roofline.peak_source(OPS_RATE["rate"])})
        if plains is not None:
            plains.append(out_p)
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
    fused_render_kernel<IMAGES, walk> (without and with the image fetch)
    and bounce_kernel<REGEN, walk> (one-bounce and regenerating modes) for
    each tree walk, closest_hit_kernel, and chain_kernel<op, chains,
    unroll>."""
    import re

    from zig_weekend_raytracer_tpu_torch.ops.trace import WALKS
    from zig_weekend_raytracer_tpu_torch.tools.fp32_peak import OPS

    def name_of(mangled):
        m = re.search(r"(fused_render_kernel|bounce_kernel)ILb([01])ELi(\d)E", mangled)
        if m:
            return f"{m.group(1)}<{'true' if m.group(2) == '1' else 'false'}, {WALKS[int(m.group(3))]}>"
        m = re.search(r"chain_kernelILi(\d)ELi(\d+)ELi(\d+)E", mangled)
        if m:
            return f"chain_kernel<{OPS[int(m.group(1))]}, {m.group(2)}, {m.group(3)}>"
        return "closest_hit_kernel" if "closest_hit_kernel" in mangled else None

    out, cur = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = name_of(m.group(1))
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


def sass_counts(lib_path: str) -> dict:
    """{chain_kernel<op, chains, unroll>: {opcode: count}} of the FP32
    opcodes in each chain kernel's SASS (cuobjdump -sass): the fma chain
    must be FFMA, not an FMUL and an FADD (the build has -fmad=false)."""
    import re
    import shutil

    from zig_weekend_raytracer_tpu_torch.tools.fp32_peak import OPS

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    proc = subprocess.Popen([tool, "-sass", lib_path], stdout=subprocess.PIPE, text=True)
    out, cur = {}, None
    for line in proc.stdout:
        m = re.search(r"Function : (\S+)", line)
        if m:
            k = re.search(r"chain_kernelILi(\d)ELi(\d+)ELi(\d+)E", m.group(1))
            cur = f"chain_kernel<{OPS[int(k.group(1))]}, {k.group(2)}, {k.group(3)}>" if k else None
            if cur:
                out[cur] = {}
            continue
        if cur:
            m = re.search(r"\b(FFMA|FADD|FMUL|FSETP|FSEL|FMNMX)\b", line)
            if m:
                out[cur][m.group(1)] = out[cur].get(m.group(1), 0) + 1
    if proc.wait() != 0:
        raise AssertionError(f"cuobjdump -sass failed ({proc.returncode})")
    return out


def phase_fp32_peak(torch, built, card) -> dict:
    """Phase 1b: chain_kernel against its plain version on the card for the
    four ops at every (blocks per SM, chains, unroll) of the sweep, on the
    sweep's own grid with CHAIN_STEPS steps, its SASS, then the sweep with
    the scaling check (its launches counted); sets OPS_RATE to the measured
    add rate."""
    import numpy as np

    from zig_weekend_raytracer_tpu_torch.tools import fp32_peak as fp
    from zig_weekend_raytracer_tpu_torch.utils import roofline

    c = fp.multipliers("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    parity = []
    for blocks, chains, unroll in fp.SWEEP:
        n = sms * blocks * fp.THREADS
        iters = CHAIN_STEPS // unroll
        for op in fp.OPS:
            ms_k, out_k = cuda_time_ms(lambda: fp.chain(op, c, n, iters, chains, unroll), 3)
            ms_p, out_p = cuda_time_ms(lambda: fp.chain_reference(op, c, n, iters, chains, unroll))
            k, p = out_k.cpu().numpy(), out_p.cpu().numpy()
            err = float(np.abs(k - p).max())
            bad = int((~np.isclose(k, p, rtol=CHAIN_RTOL, atol=0.0)).sum())
            tag = f"chain {op}, {blocks} blocks/SM, {chains} chains, unroll {unroll}"
            log(f"{tag}: {n} threads, {iters} iters: outside rtol {CHAIN_RTOL} on {bad}, "
                f"max |diff| {err:.3e}; kernel {ms_k:.3f} ms, plain {ms_p:.1f} ms")
            if bad or not np.isfinite(k).all():
                raise AssertionError(f"{tag}: chain_kernel disagrees with its plain version")
            parity.append({"check": tag, "op": op, "shape": [blocks, chains, unroll],
                           "threads": n, "iters": iters, "max_abs_err": err, "ms": ms_k,
                           "plain_ms": ms_p})
    sass = sass_counts(built["path"])
    for name, ops in sorted(sass.items()):
        log(f"  sass {name}: {ops}")
    fma = sass.get("chain_kernel<fma, 8, 64>", {})
    if fma.get("FFMA", 0) < 8 * 64 or fma.get("FMUL", 0) + fma.get("FADD", 0) >= 8 * 64:
        raise AssertionError(f"the fma chain is not FFMA in the SASS: {fma}")
    fp.chain.launches = 0
    res = fp.run(fp.ITERS_QUICK)
    launches = fp.chain.launches
    for r in res["sweep"]:
        log(f"  sweep {r['op']} blocks/SM {r['blocks_per_sm']} chains {r['chains']} unroll "
            f"{r['unroll']}: {r['time_s'] * 1e3:.3f} ms, {r['gops']:.1f} Gops/s, "
            f"{r['gflops']:.1f} GFLOP/s")
    sc = res["iters_scaling"]
    log(f"fp32 peak (best of 3, {card}): Gops/s {res['gops']}, GFLOP/s {res['gflops']}; "
        f"physics bound {res['physics_bound']}; 4x/1x iters time ratio "
        f"{sc['time_ratio_4x']:.3f}; {launches} launches")
    if not res["ok"]:
        raise AssertionError(f"fp32 peak: over the physics bound {res['over_physics']} or "
                             f"not linear in iters ({sc['time_ratio_4x']:.3f})")
    OPS_RATE["rate"] = res["add_gops"] * 1e9
    best = next(r for r in res["sweep"] if r["op"] == "add"
                and [r["blocks_per_sm"], r["chains"], r["unroll"]] == res["best_shape"]["add"])
    # the headline add run: its lane-operations over the data sheet's rate,
    # 128 multipliers in and one float per thread out
    ops = best["threads"] * best["chains"] * best["iters"] * best["unroll"]
    bound, by = roofline.bound_ms(ops, 128 * 4 + best["threads"] * 4)
    add_parity = next(p for p in parity
                      if p["op"] == "add" and p["shape"] == res["best_shape"]["add"])
    return {"parity": parity, "ms": best["time_s"] * 1e3, "plain_ms": add_parity["plain_ms"],
            "kernel_ms_at_plain_shape": add_parity["ms"], "bound_ms": bound, "bound_by": by,
            "instantiation": f"chain_kernel<add, {best['chains']}, {best['unroll']}>",
            "peak_source": roofline.peak_source(None), "launches": launches,
            "gops": res["gops"], "gflops": res["gflops"], "best_shape": res["best_shape"],
            "physics_bound": res["physics_bound"], "time_ratio_4x": sc["time_ratio_4x"],
            "sass": sass}


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


def regen_parity(zt, tb, integrator, torch, scene, w, spp, depth, tag, lanes=None,
                 plains=None):
    """bounce_kernel's regenerating mode vs bounce_regen_reference from
    fresh lanes (every pixel of a w x w image, or ``lanes`` = (px, py) of
    a plan), checked with phase 2's tolerances; every lane must end
    drained.  Returns the check (with both times), the plain version's work
    counts and the kernel's total bounces; ``plains``, a list, collects the
    plain version's final state."""
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
    if plains is not None:
        plains.append(st_p)
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


def walk_scenes(zt) -> dict:
    """The scenes of phases 17 and 18: balls at leaf span 2, rtw_final with
    the atlas, and rtw_final compiled with ZWRT_UNI_TREE=1 with the atlas
    and with a native-budget texture LUT."""
    out = {}
    with leaf_span(2):
        out["balls2"] = zt.models.load_scene("balls", device="cuda")
    out["rtw"] = zt.models.load_scene("rtw_final", device="cuda")
    with env("ZWRT_UNI_TREE", "1"):
        out["rtw_uni"] = zt.models.load_scene("rtw_final", device="cuda")
        out["rtw_uni_lut"] = zt.models.load_scene("rtw_final", device="cuda",
                                                  texture_lut=LUT_NATIVE)
    out["rtw_lut"] = zt.models.load_scene("rtw_final", device="cuda", texture_lut=LUT_NATIVE)
    cu = out["rtw_uni"].compiled
    log(f"unified tree of rtw_final: {cu.uni_tree_box.shape[0]} nodes at leaf span "
        f"{cu.uni_leaf_span} (per-kind trees {cu.sph_tree_box.shape[0]} + "
        f"{cu.quad_tree_box.shape[0]} nodes)")
    if not (cu.has_uni_tree and out["rtw_uni_lut"].compiled.has_uni_tree):
        raise AssertionError("rtw_final compiled without its unified tree under ZWRT_UNI_TREE=1")
    return out


def phase_walk_parity(zt, fused, tb, integrator, torch, sc) -> dict:
    """Phase 17: each walk's instantiations against their plain versions on
    the card (K1 on balls at span 2, K2's regenerating mode and its
    one-bounce mode with every lane live and with every other lane dead on
    rtw_final, K1 with the LUT on rtw_final under uni), and each walk's
    plain version against the default walk's plain version on the same
    inputs.  Returns {walk: {case: (check, plain work counts or None)}} and
    the plain-vs-plain checks under "plain"."""

    def cases(walk):
        """{case: (check, plain output, plain work counts or None)}."""
        rtw = sc["rtw_uni" if walk == "uni" else "rtw"]
        out = {}
        if walk != "uni":  # balls has no quads, so no unified tree
            plains = []
            check = render_parity(zt, fused, integrator, torch, sc["balls2"],
                                  f"{walk} walk: balls span 2 32x32 spp{WALK_SPP} d{DEPTH}",
                                  plains=plains, spp=WALK_SPP)
            out["K1 balls"] = (check, *plains[0])
        plains = []
        check, counts, _ = regen_parity(zt, tb, integrator, torch, rtw, 32, WALK_SPP, RTW_DEPTH,
                                        f"{walk} walk: rtw_final 32x32 spp{WALK_SPP} "
                                        f"d{RTW_DEPTH}", plains=plains)
        out["K2 regen"] = (check, plains[0], counts)
        if walk in ("uni", "cond"):
            plains = []
            check = render_parity(zt, fused, integrator, torch,
                                  sc["rtw_uni_lut" if walk == "uni" else "rtw_lut"],
                                  f"{walk} walk: rtw_final LUT 32x32 spp{WALK_SPP} d{RTW_DEPTH}",
                                  RTW_DEPTH, plains=plains, spp=WALK_SPP)
            out["K1 LUT"] = (check, *plains[0])
        plains = []
        check = one_bounce_parity(zt, tb, integrator, torch, rtw, f"{walk} walk: rtw_final",
                                  (0,), plains)[0]
        out["K2 one bounce"] = (check, plains[0], None)
        # every other lane dead: the live lanes of a warp reach the trace
        # from a divergent branch (the rowqueue walk's group is half a warp)
        plains = []
        odd = torch.arange(W * H, device="cuda") % 2 == 1
        check = one_bounce_parity(zt, tb, integrator, torch, rtw,
                                  f"{walk} walk: rtw_final, every other lane dead", (0,), plains,
                                  alive0=odd)[0]
        out["K2 one bounce, half dead"] = (check, plains[0], None)
        return out

    result, default = {"plain": []}, None
    for walk in ("cond",) + NEW_WALKS:
        with trav(walk):
            got = cases(walk)
        result[walk] = {name: (check, counts) for name, (check, _, counts) in got.items()}
        if default is None:
            default = got
            continue
        for name, (_, mine, _) in got.items():
            ref = default[name][1]
            tag = f"plain {walk} walk vs plain default walk: {name}"
            if name.startswith("K2 one bounce"):
                result["plain"].append(compare_bounce(tag, mine, ref))
            elif name == "K2 regen":
                result["plain"].append(compare(tag, (mine.radiance, mine.work),
                                               (ref.radiance, ref.work)))
            else:
                result["plain"].append(compare(tag, mine, ref))
    return result


def walk_render(zt, fused, integrator, ch, ttrace, tb, torch, scene, spp, depth, walk, card,
                ref_fb=None) -> dict:
    """Phase 18, one path: ``scene`` at 400x400 under ``walk`` (one warmup
    render, three timed), with the counts set to 0 just before and read just
    after; the walk's instantiation of K1 (scenes it takes) or K2 must have
    launched and nothing else of the kind, no plain version; then the
    kernel's time at the coherent plan's lanes (its work), and the
    framebuffer against ``ref_fb`` within rtol 1e-5 / atol 1e-6 on >= 99.9%
    of pixels."""
    from zig_weekend_raytracer_tpu_torch.ops.bounce import supports_fused_render
    from zig_weekend_raytracer_tpu_torch.render.camera import camera_consts

    cs = scene.compiled
    k1 = supports_fused_render(cs)
    renderer = zt.render.Renderer(samples_per_pixel=spp, max_ray_bounce_depth=depth)
    tag = f"{scene.name} {W}x{H}@{spp} d{depth}, {walk} walk"
    with trav(walk):
        reset_counts(fused, integrator, ch, ttrace, tb)
        warm_s, times, fb = timed_renders(renderer, scene, torch, W, H)
        host = fused.render_fused if k1 else tb.bounce_regen
        other = ((launched(tb.bounce_regen) + launched(tb.bounce)) if k1
                 else launched(fused.render_fused))
        by_walk = dict(host.launches)
        launches = sum(by_walk.values())
        n_plain = plain_calls(integrator, ttrace)
        log(f"{tag}: warmup {warm_s:.3f} s, renders {[round(t, 4) for t in times]} s; "
            f"{'render' if k1 else 'bounce'} kernel launches by walk {by_walk}, other render "
            f"kernel {other}, plain-version calls {n_plain}")
        if by_walk[walk] < 1 or by_walk[walk] != launches or other or n_plain:
            raise AssertionError(f"{tag}: did not run the {walk} instantiation alone")
        if tuple(fb.shape) != (H, W, 3) or not bool(torch.isfinite(fb).all()):
            raise AssertionError(f"{tag}: bad framebuffer")
        plans = renderer._plan_cache[cs]
        plan = plans[next(k for k in plans if k[0] == "coh")]["plan"]
        kw = dict(camera_consts=camera_consts(scene.camera, W, H), sampler=renderer.sampler,
                  width=W, height=H, spp=spp, stride=1, max_depth=depth,
                  has_dof=scene.camera.has_depth_of_field)
        t_min = zt.dtypes.T_MIN
        if k1:
            ms, (_, work) = cuda_time_ms(
                lambda: fused.render_fused(cs, *plan, 0, t_min, want_work=True, **kw), 3)
        else:
            st0 = integrator.initial_regen_state(plan[2], 1)
            ms, st = cuda_time_ms(
                lambda: tb.bounce_regen(cs, st0, plan[0], plan[1], plan[3], 0, t_min, **kw), 3)
            work = st.work
    best = min(times)
    mpaths = W * H * spp / best / 1e6
    out = {"render_s_best": best, "mpaths_per_s": mpaths, "launches": launches, "ms": ms,
           "work": int(work.sum().item()), "lanes": int(plan[0].shape[0])}
    msg = f"{tag}: best {best:.4f} s = {mpaths:.2f} Mpaths/s; kernel at the plan {ms:.3f} ms"
    if ref_fb is not None:
        close = torch.isclose(fb, ref_fb, rtol=1e-5, atol=1e-6).all(-1).float().mean().item()
        out.update(default_agree=close, default_max_abs_diff=(fb - ref_fb).abs().max().item())
        msg += (f"; against the default walk's render {close:.4%} of pixels within rtol "
                f"1e-5/atol 1e-6, max |diff| {out['default_max_abs_diff']:.3e}")
        if close < 0.999:
            raise AssertionError(f"{tag}: disagrees with the default walk's render")
    log(f"{msg} ({card})")
    return out, fb


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
        from zig_weekend_raytracer_tpu_torch.utils import workcount
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        return 2
    if "jax" in sys.modules or "zig_weekend_raytracer_tpu" in sys.modules:
        print("chip_smoke: JAX was imported", file=sys.stderr)
        return 1

    # ---- 1. device and build ----
    phase("1")
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
    n_chain = 4 * 2 * 4  # ops x chain counts x unrolls
    if len(resources) != 2 * 2 * 5 + 1 + n_chain or any(
            r["registers"] is None for r in resources.values()):
        raise AssertionError(f"ptxas did not report every kernel: {sorted(resources)}")
    for name, (regs, spill) in DEFAULT_RESOURCES.items():
        got = (resources[name]["registers"], resources[name]["spill_bytes"])
        if got != (regs, spill):
            raise AssertionError(f"{name}: {got} registers and spill bytes, not the previous "
                                 f"slice's {(regs, spill)}")
    _build.load_library()

    # ---- 1b. the FP32 peak: every later bound divides by its add rate ----
    phase("1b")
    peak = phase_fp32_peak(torch, built, card)

    # ---- 2. kernel against plain ----
    phase("2")
    cornell = zt.models.load_scene("cornell_box", device="cuda")
    checks = [render_parity(zt, fused, integrator, torch, cornell, "cornell 32x32 spp8 d10")]

    # ---- 3. the main path ----
    phase("3")
    renderer = zt.render.Renderer(samples_per_pixel=SPP, max_ray_bounce_depth=DEPTH)
    reset_counts(fused, integrator, ch, ttrace, tb)
    warm_s, times, fb = timed_renders(renderer, cornell, torch, W, H)
    launches = launched(fused.render_fused)
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
    phase("4")
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
    with workcount.counting() as k1_counts:
        plain_ms, out_p = plain(plan, plain_spp, want_work=True)
    kernel_ms_same, out_k = kernel(plan, plain_spp, 3)
    log(
        f"plain version at main-path lanes, {plain_spp} spp: {plain_ms:.1f} ms; "
        f"kernel at {plain_spp} spp: {kernel_ms_same:.3f} ms; "
        f"ratio {plain_ms / kernel_ms_same:.1f}x ({card})"
    )
    checks.append(compare(f"main-path lanes {plain_spp} spp d{DEPTH}", out_k, out_p))
    # every sample bit of the main path: a slice spread over the cost-sorted
    # plan, its lanes in 64-sample windows that together cover the full spp
    # (the Sobol scale comes from W and H)
    checks.append(plan_parity(zt, fused, integrator, cornell, plan, SPP, card, "main-path",
                              window=64)[0])
    # each lane's accumulation over the full 1024 samples, on a smaller
    # slice at a cut depth
    checks.append(plan_parity(zt, fused, integrator, cornell, plan, SPP, card, "main-path",
                              depth=FULL_DRAIN_DEPTH, lanes=FULL_DRAIN_LANES)[0])
    # the timed run's lanes read (px, py, s0, s1) and write radiance and
    # work; its bound from the work of every lane at plain_spp
    k1_bound = render_bound(zt, cornell, dict(k1_counts), main_work.sum().item(), n * (16 + 16),
                            False)

    # ---- 5. closest-hit kernel against plain ----
    phase("5")
    hit_checks = phase_closest_hit(zt, ch, ttrace, torch)

    # ---- 6. render kernel with the tree walk and depth of field ----
    phase("6")
    balls = zt.models.load_scene("balls", device="cuda")
    with leaf_span(2):
        balls2 = zt.models.load_scene("balls", device="cuda")
    tree_checks = [
        render_parity(zt, fused, integrator, torch, balls, "balls 32x32 spp8 d10, default span"),
        render_parity(zt, fused, integrator, torch, balls2, "balls 32x32 spp8 d10, span 2"),
    ]

    # ---- 7. the balls main path ----
    phase("7")
    b_renderer = zt.render.Renderer(samples_per_pixel=BALLS_SPP, max_ray_bounce_depth=DEPTH)
    reset_counts(fused, integrator, ch, ttrace, tb)
    b_warm_s, b_times, b_fb = timed_renders(b_renderer, balls, torch, W, H)
    b_launches = launched(fused.render_fused)
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
    phase("8")
    balls_gates = region_gates(zt, np, balls, "balls")

    # ---- 9. bounce kernel, one-bounce mode, against plain ----
    phase("9")
    images = {name: zt.models.load_scene(name, device="cuda")
              for name in ("rtw_final", "shrek_quads", "earth")}
    rtw = images["rtw_final"]
    k2_one = phase_one_bounce(zt, tb, integrator, torch, images)
    k2_checks = []

    # ---- 10. bounce kernel, regenerating mode, against plain ----
    phase("10")
    for name, depth in (("earth", 10), ("shrek_quads", 10), ("rtw_final", RTW_DEPTH)):
        tag = f"{name} 32x32 spp8 d{depth}"
        k2_checks.append(regen_parity(zt, tb, integrator, torch, images[name], 32, 8, depth, tag)[0])

    # ---- 11. the rtw_final main path ----
    phase("11")
    r_renderer = zt.render.Renderer(samples_per_pixel=RTW_SPP, max_ray_bounce_depth=RTW_DEPTH)
    reset_counts(fused, integrator, ch, ttrace, tb)
    torch.cuda.reset_peak_memory_stats()
    r_warm_s, r_times, r_fb = timed_renders(r_renderer, rtw, torch, W, H)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    r_k2 = launched(tb.bounce_regen) + launched(tb.bounce)
    r_hit = ch.closest_hit.launches
    r_k1 = launched(fused.render_fused)
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
    phase("12")
    # rtw_final's 64x64 golden holds 2,048 samples per 8x8-pixel region,
    # too few for its dark regions, whose light comes from rare paths: those
    # decorrelate from the golden's (XLA's contracted multiply-adds; the
    # port equals the JAX integrator run unfused, lane for lane), so its
    # gate takes 4x4 regions of 8,192 samples
    image_gates = {name: region_gates(zt, np, images[name], name,
                                      grid64=4 if name == "rtw_final" else 8)
                   for name in ("earth", "shrek_quads", "rtw_final")}

    # ---- 13. the render kernel with a texture LUT against plain ----
    phase("13")
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
    phase("14")
    l_renderer = zt.render.Renderer(samples_per_pixel=RTW_SPP, max_ray_bounce_depth=RTW_DEPTH)
    reset_counts(fused, integrator, ch, ttrace, tb)
    torch.cuda.reset_peak_memory_stats()
    l_warm_s, l_times, l_fb = timed_renders(l_renderer, rtw_lut, torch, W, H)
    l_peak_mb = torch.cuda.max_memory_allocated() / 2**20
    l_k1 = launched(fused.render_fused)
    l_k2 = launched(tb.bounce_regen) + launched(tb.bounce)
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
    phase("15")
    emissive = zt.models.load_scene("emissive", device="cuda")
    checks.append(render_parity(zt, fused, integrator, torch, emissive, "emissive 32x32 spp8 d10"))
    e_renderer = zt.render.Renderer(samples_per_pixel=EMISSIVE_SPP, max_ray_bounce_depth=DEPTH)
    reset_counts(fused, integrator, ch, ttrace, tb)
    e_warm_s, e_times, e_fb = timed_renders(e_renderer, emissive, torch, W, H)
    e_k1 = launched(fused.render_fused)
    e_other = launched(tb.bounce) + launched(tb.bounce_regen) + ch.closest_hit.launches
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
    phase("16")
    cli_checks = phase_cli(zt, torch)

    # ---- 17. the tree walks against their plain versions ----
    phase("17")
    wsc = walk_scenes(zt)
    wpar = phase_walk_parity(zt, fused, tb, integrator, torch, wsc)

    # ---- 18. the walks on the slice's path at full width ----
    phase("18")
    wr = lambda scene, spp, depth, walk, ref=None: walk_render(
        zt, fused, integrator, ch, ttrace, tb, torch, scene, spp, depth, walk, card, ref)
    paths = {}
    b_default, b2_fb = wr(wsc["balls2"], BALLS_SPP, DEPTH, "cond")
    b_default.update(render_bound(zt, wsc["balls2"], wpar["cond"]["K1 balls"][1],
                                  b_default["work"], b_default["lanes"] * (16 + 12), True))
    paths[("K1", "cond")] = b_default
    for walk in ("queue", "rowqueue", "spec"):
        paths[("K1", walk)] = wr(wsc["balls2"], BALLS_SPP, DEPTH, walk, b2_fb)[0]
        paths[("K2", walk)] = wr(rtw, RTW_SPP, RTW_DEPTH, walk, r_fb)[0]
    paths[("K2", "uni")], uni_fb = wr(wsc["rtw_uni"], RTW_SPP, RTW_DEPTH, "uni", r_fb)
    paths[("K1", "uni")] = wr(wsc["rtw_uni_lut"], RTW_SPP, RTW_DEPTH, "uni", l_fb)[0]
    uni_gates = region_gates(zt, np, wsc["rtw_uni"], "rtw_final", grid64=4)
    log("walks at full width (Mpaths/s; " + card + "): " + ", ".join(
        f"{k} {w} {v['mpaths_per_s']:.2f}" for (k, w), v in paths.items())
        + f"; default walk: balls span 2 {b_default['mpaths_per_s']:.2f}, rtw_final (K2) "
        f"{r_mpaths:.2f}, rtw_final LUT (K1) {l_mpaths:.2f}")

    b_hit = hit_checks[1]
    k2_first = k2_one[0]
    k2_lut_first = k2_lut[0]
    bound_of = lambda c: {k: c[k] for k in ("bound_ms", "bound_by", "peak_source")}

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

    def walk_entry(kernel, walk):
        """The record of one walk's instantiation on its phase 18 path; its
        bound from phase 17's plain work counts (32x32) scaled to the
        kernel's bounces at the plan."""
        path = paths[(kernel, walk)]
        checks = wpar[walk]
        if kernel == "K1":
            case = "K1 LUT" if walk == "uni" else "K1 balls"
            scene = wsc["rtw_uni_lut"] if walk == "uni" else wsc["balls2"]
            name = f"fused_render_kernel ({walk} walk" + (", texture LUT)" if walk == "uni" else ")")
            res = f"fused_render_kernel<{'true' if walk == 'uni' else 'false'}, {walk}>"
            parity = [checks[case][0]]
            lane_bytes = path["lanes"] * (16 + (16 if walk == "uni" else 12))
            src, by_path = KERNEL_SOURCE, {scene.name + (" uni LUT" if walk == "uni" else
                                                         " span 2"): path["launches"]}
        else:
            case = "K2 regen"
            scene = wsc["rtw_uni"] if walk == "uni" else rtw
            name = f"bounce_kernel ({walk} walk, regenerating)"
            res = f"bounce_kernel<true, {walk}>"
            parity = [checks[c][0] for c in ("K2 regen", "K2 one bounce",
                                             "K2 one bounce, half dead")]
            lane_bytes = path["lanes"] * (84 + 72)
            src, by_path = BOUNCE_SOURCE, {"rtw_final" + (" uni" if walk == "uni" else ""):
                                           path["launches"]}
        bound = render_bound(zt, scene, checks[case][1], path["work"], lane_bytes,
                             scene.camera.has_depth_of_field)
        return entry(name, src, WALK_REPLACES[walk], res, path["launches"], by_path, parity,
                     path["ms"], parity[0]["plain_ms"], bound, render_tol,
                     plain_lanes=32 * 32, render_s_best=path["render_s_best"],
                     mpaths_per_s=path["mpaths_per_s"],
                     default_agree=path.get("default_agree"),
                     plain_vs_default_plain=[c for c in wpar["plain"] if f" {walk} walk" in c["check"]],
                     **({"region_gates": uni_gates} if (kernel, walk) == ("K2", "uni") else {}))

    record = {"kernels": [
        entry("fused_render_kernel (brute)", KERNEL_SOURCE, KERNEL_REPLACES,
              "fused_render_kernel<false, cond>", launches + e_k1,
              {"cornell": launches, "emissive": e_k1}, checks, kernel_ms, plain_ms, k1_bound,
              render_tol, plain_spp=plain_spp, kernel_ms_at_plain_spp=kernel_ms_same,
              render_s_best=best, mpaths_per_s=mpaths, region_gate=verdict,
              emissive_render_s_best=e_best, emissive_mpaths_per_s=e_mpaths,
              emissive_region_gates=emissive_gates),
        entry("fused_render_kernel (tree)", KERNEL_SOURCE, KERNEL_REPLACES,
              "fused_render_kernel<false, cond>", b_launches, {"balls": b_launches}, tree_checks,
              b_kernel_ms, b_slice["plain_ms"], k1_tree_bound, render_tol,
              plain_lanes=SLICE_LANES, kernel_ms_at_plain_lanes=b_slice["ms"],
              balls_render_s_best=b_best, balls_mpaths_per_s=b_mpaths,
              balls_region_gates=balls_gates),
        entry("fused_render_kernel (texture LUT)", KERNEL_SOURCE, KERNEL_LUT_REPLACES,
              "fused_render_kernel<true, cond>", l_k1, {"rtw_final LUT": l_k1}, lut_checks,
              l_kernel_ms, l_slice["plain_ms"], k1_lut_bound, render_tol,
              plain_lanes=SLICE_LANES // 2, kernel_ms_at_plain_lanes=l_slice["ms"],
              rtw_final_render_s_best=l_best, rtw_final_mpaths_per_s=l_mpaths,
              rtw_final_peak_mib=l_peak_mb, atlas_render_agree=l_close,
              atlas_render_max_abs_diff=l_vs_atlas, region_gates=lut_gates,
              lut_32k_mpaths_per_s=s_mpaths, lut_32k_mean_abs_diff=s_diff,
              lut_vs_atlas_pairs_ms=lut_pairs, lut_vs_atlas_same_lanes=lut_same_lanes),
        entry("bounce_kernel (one bounce)", BOUNCE_SOURCE, BOUNCE_REPLACES, "bounce_kernel<false, cond>",
              0, {}, k2_one, k2_first["ms"], k2_first["plain_ms"], bound_of(k2_first), bounce_tol,
              note="parity only: no main path runs the one-bounce mode; times and bound "
                   "are rtw_final's first bounce at 160,000 lanes"),
        entry("bounce_kernel (one bounce, texture LUT)", BOUNCE_SOURCE, BOUNCE_REPLACES,
              "bounce_kernel<false, cond>", 0, {}, k2_lut, k2_lut_first["ms"],
              k2_lut_first["plain_ms"], bound_of(k2_lut_first), bounce_tol,
              note="parity only: no main path runs the one-bounce mode"),
        entry("bounce_kernel (regenerating)", BOUNCE_SOURCE, BOUNCE_REPLACES,
              "bounce_kernel<true, cond>", r_k2, {"rtw_final": r_k2}, k2_checks, k2_ms,
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
        *(walk_entry(kernel, walk) for kernel in ("K1", "K2") for walk in NEW_WALKS),
        {"name": "chain_kernel (fp32 peak)", "route": "cuda", "source": PEAK_SOURCE,
         "replaces": PEAK_REPLACES, "launches": peak["launches"],
         "launches_by_path": {"fp32 peak sweep": peak["launches"]},
         "max_abs_err": max(c["max_abs_err"] for c in peak["parity"]), "ms": peak["ms"],
         "plain_ms": peak["plain_ms"], "bound_ms": peak["bound_ms"],
         "bound_by": peak["bound_by"], "peak_source": peak["peak_source"], "library_ms": None,
         "library_note": "none: no single PyTorch call runs a register-resident operation chain",
         "registers": resources[peak["instantiation"]]["registers"],
         "spill_bytes": resources[peak["instantiation"]]["spill_bytes"],
         "parity": peak["parity"], "tolerance": f"rtol {CHAIN_RTOL}", "card": card,
         "note": f"ms: {peak['instantiation']} at the best add shape of the sweep; "
                 f"plain_ms at that shape with {CHAIN_STEPS} steps (iters x unroll), "
                 f"where the kernel took {peak['kernel_ms_at_plain_shape']:.4f} ms",
         **{k: peak[k] for k in ("gops", "gflops", "best_shape", "physics_bound",
                                 "time_ratio_4x", "sass")}},
    ], "cli": cli_checks, "ops_rate": OPS_RATE["rate"],
        "default_walk_balls_span2": b_default}
    log(f"script: {time.perf_counter() - START:.1f} s")
    print(card, flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
