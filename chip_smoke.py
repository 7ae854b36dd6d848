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
     both times printed.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Without CUDA, or without the package next
to this script, it exits nonzero and prints no result.
"""

from __future__ import annotations

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
KERNEL_SOURCE = "zig_weekend_raytracer_tpu_torch/csrc/fused_render.cu"
KERNEL_REPLACES = "zig_weekend_raytracer_tpu/ops/pallas_bounce.py:1531"
PLAIN_BUDGET_S = 60.0
SLICE_LANES = 4096


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


def phase_parity(zt, fused, integrator, torch) -> dict:
    """Kernel vs plain version on the card at 32x32, 8 spp, depth 10."""
    from zig_weekend_raytracer_tpu_torch.render.camera import camera_consts

    w = h = 32
    spp, depth = 8, 10
    scene = zt.models.load_scene("cornell_box", device="cuda")
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
        stride=1, max_depth=depth, has_dof=False, want_work=True,
    )
    t_min = zt.dtypes.T_MIN
    out_k = fused.render_fused(scene.compiled, px, py, s0, s1, 0, t_min, **kw)
    out_p = integrator.render_fused_reference(scene.compiled, px, py, s0, s1, 0, t_min, **kw)
    torch.cuda.synchronize()
    return compare("32x32 spp8 d10", out_k, out_p)


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
        from zig_weekend_raytracer_tpu_torch.ops import fused_render as fused
        from zig_weekend_raytracer_tpu_torch.render import integrator
        from zig_weekend_raytracer_tpu_torch.utils.goldengate import check_framebuffer
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
        if "registers" in line or "spill" in line or "stack frame" in line:
            log(f"  ptxas: {line.strip()}")
    _build.load_library()

    # ---- 2. kernel against plain ----
    checks = [phase_parity(zt, fused, integrator, torch)]

    # ---- 3. the main path ----
    scene = zt.models.load_scene("cornell_box", device="cuda")
    renderer = zt.render.Renderer(samples_per_pixel=SPP, max_ray_bounce_depth=DEPTH)
    fused.render_fused.launches = 0
    integrator.render_fused_reference.calls = 0
    t0 = time.perf_counter()
    renderer.render_device(scene, W, H)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    times = []
    fb = None
    for _ in range(3):
        t0 = time.perf_counter()
        fb = renderer.render_device(scene, W, H)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = fused.render_fused.launches
    plain_calls = integrator.render_fused_reference.calls
    log(f"main path: warmup {warm_s:.3f} s, renders {[round(t, 4) for t in times]} s")
    log(f"main path: kernel launches {launches}, plain-version calls {plain_calls}")
    if launches < 1:
        raise AssertionError("the main path launched no kernel")
    if plain_calls != 0:
        raise AssertionError("the main path ran the plain version")
    fb_np = fb.cpu().numpy()
    if fb_np.shape != (H, W, 3) or not np.isfinite(fb_np).all():
        raise AssertionError(f"bad framebuffer: shape {fb_np.shape}")
    with open(GOLDEN) as f:
        ref = json.load(f)
    verdict = check_framebuffer(fb_np, ref["mean"], np.asarray(ref["region_means"]))
    log(f"region gate: {verdict} (mean {fb_np.mean():.5f} vs {ref['mean']:.5f})")
    if not verdict.startswith("pass"):
        raise AssertionError(f"region gate failed: {verdict}")
    best = min(times)
    mpaths = W * H * SPP / best / 1e6
    log(
        f"main path best {best:.4f} s = {mpaths:.2f} Mpaths/s "
        f"(cornell {W}x{H}@{SPP} spp d{DEPTH}; {card})"
    )

    # ---- 4. kernel against plain at the main path's lanes ----
    key = (W, H, 0, SPP, DEPTH, renderer.sampler, renderer.seed)
    px, py, s0, s1 = renderer._plan_cache[scene.compiled][key]["plan"]
    n = px.shape[0]
    from zig_weekend_raytracer_tpu_torch.render.camera import camera_consts

    kw = dict(
        camera_consts=camera_consts(scene.camera, W, H), sampler=renderer.sampler,
        width=W, height=H, spp=SPP, stride=1, max_depth=DEPTH, has_dof=False,
    )
    t_min = zt.dtypes.T_MIN
    kernel_ms, _ = cuda_time_ms(
        lambda: fused.render_fused(scene.compiled, px, py, s0, s1, 0, t_min, **kw), 3
    )
    log(f"kernel at main-path lanes ({n} lanes, {SPP} spp): {kernel_ms:.3f} ms")

    def plain(lanes, spp, want_work=False):
        lim = torch.full_like(lanes[3], spp)
        return cuda_time_ms(
            lambda: integrator.render_fused_reference(
                scene.compiled, *lanes[:3], lim, 0, t_min, want_work=want_work, **kw
            )
        )

    def kernel(lanes, spp, repeats):
        lim = torch.full_like(lanes[3], spp)
        return cuda_time_ms(
            lambda: fused.render_fused(
                scene.compiled, *lanes[:3], lim, 0, t_min, want_work=True, **kw
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
    step = n // SLICE_LANES
    sub = tuple(a[::step][:SLICE_LANES].contiguous() for a in plan)
    slice_plain_ms, out_p = plain(sub, SPP, want_work=True)
    slice_kernel_ms, out_k = kernel(sub, SPP, 1)
    log(
        f"plain version at {SLICE_LANES} main-path lanes, {SPP} spp: "
        f"{slice_plain_ms:.1f} ms; kernel {slice_kernel_ms:.3f} ms ({card})"
    )
    checks.append(compare(f"{SLICE_LANES} main-path lanes {SPP} spp d{DEPTH}", out_k, out_p))

    record = {"kernels": [{
        "name": "fused_render_kernel",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in checks),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "plain_spp": plain_spp,
        "kernel_ms_at_plain_spp": kernel_ms_same,
        "parity": checks,
        "tolerance": "rtol 1e-4, atol 1e-5 on >= 99% of lanes; mean 1e-4 rel",
        "render_s_best": best,
        "mpaths_per_s": mpaths,
        "region_gate": verdict,
        "card": card,
    }]}
    print(json.dumps(record), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
