"""Leaf span x tree walk sweep of the render and bounce kernels on the card.

    python -m zig_weekend_raytracer_tpu_torch.tools.span_sweep

Cells: each leaf span of ``SPANS`` (``ZWRT_LEAF_GROUPS`` at scene compile,
for both primitive kinds) under each walk of ``WALKS`` (``ZWRT_TRAV`` at
launch), on balls 400x400@128 d10 (the render kernel) and rtw_final
400x400@64 d8 (the bounce kernel with the atlas), and on rtw_final, which
has both kinds, under the ``uni`` walk too (the unified tree,
``ZWRT_UNI_TREE=1`` at scene compile, at the same span).  Each cell: one warmup
render (it builds the coherent plan), the best of three timed renders
(Mpaths/s), the kernel's time at the plan's lanes (best of three CUDA-event
runs), the peak device memory of the renders, and the framebuffer against
the JAX-span ``cond`` render of the same run (span 64 for balls' 485
spheres, 32 for rtw_final's 1,005 spheres and 2,401 quads): every pixel
that differs at all is counted.  ``pairs`` times two settings of one scene
in alternating pairs: cond against queue at each scene's best span, and
uni against queue on rtw_final at the package's span.  Prints one JSON
line; exits 2 without a card.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time

import torch

SPANS = (1, 2, 4, 8)
WALKS = ("cond", "queue")
W = H = 400
# (scene, spp, depth, the JAX package's leaf span for its trees)
SCENES = {"balls": (128, 10, 64), "rtw_final": (64, 8, 32)}
# the scenes swept under the unified tree's walk too
UNI_SCENES = ("rtw_final",)
LUT_NATIVE = 1 << 23


@contextlib.contextmanager
def env(**values):
    """Environment variables set (None: unset) for the block."""
    old = {k: os.environ.pop(k, None) for k in values}
    for k, v in values.items():
        if v is not None:
            os.environ[k] = str(v)
    try:
        yield
    finally:
        for k in values:
            os.environ.pop(k, None)
            if old[k] is not None:
                os.environ[k] = old[k]


def load(name, span=None, lut=None, walk=None):
    """``name`` on the card, its trees at leaf span ``span`` (None: the
    package's policy), with the unified tree when ``walk`` is "uni"."""
    from ..models import load_scene

    with env(ZWRT_LEAF_GROUPS=span, ZWRT_UNI_TREE=1 if walk == "uni" else None):
        return load_scene(name, device="cuda", texture_lut=lut)


def trav(walk):
    """``ZWRT_TRAV`` for ``walk``: unset for uni, which the scene's
    unified tree selects."""
    return None if walk == "uni" else walk


def render_best(scene, spp, depth, walk, reps=3):
    """(best seconds of ``reps`` timed renders, framebuffer, renderer)
    after one warmup render, under ``walk`` (None: the package default)."""
    from ..render import Renderer

    renderer = Renderer(samples_per_pixel=spp, max_ray_bounce_depth=depth)
    with env(ZWRT_TRAV=trav(walk)):
        renderer.render_device(scene, W, H)
        torch.cuda.synchronize()
        best, fb = float("inf"), None
        for _ in range(reps):
            t0 = time.perf_counter()
            fb = renderer.render_device(scene, W, H)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
    return best, fb, renderer


def kernel_ms(scene, renderer, spp, depth, walk):
    """Best of three CUDA-event times of the scene's kernel (the render
    kernel where it takes the scene, else the bounce kernel's regenerating
    mode) over the renderer's coherent plan."""
    from .. import dtypes
    from ..ops import bounce as tb
    from ..ops import fused_render as fused
    from ..render import integrator
    from ..render.camera import camera_consts

    cs = scene.compiled
    plans = renderer._plan_cache[cs]
    plan = plans[next(k for k in plans if k[0] == "coh")]["plan"]
    kw = dict(camera_consts=camera_consts(scene.camera, W, H), sampler=renderer.sampler,
              width=W, height=H, spp=spp, stride=1, max_depth=depth,
              has_dof=scene.camera.has_depth_of_field)
    if tb.supports_fused_render(cs):
        fn = lambda: fused.render_fused(cs, *plan, 0, dtypes.T_MIN, **kw)
    else:
        st0 = integrator.initial_regen_state(plan[2], 1)
        fn = lambda: tb.bounce_regen(cs, st0, plan[0], plan[1], plan[3], 0, dtypes.T_MIN, **kw)
    best = float("inf")
    with env(ZWRT_TRAV=trav(walk)):
        for _ in range(3):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            best = min(best, start.elapsed_time(end))
    return best


def cell(scene, spp, depth, walk, ref_fb=None) -> tuple:
    """One cell's record and framebuffer."""
    torch.cuda.reset_peak_memory_stats()
    best, fb, renderer = render_best(scene, spp, depth, walk)
    peak = torch.cuda.max_memory_allocated() / 2**20
    out = {"render_s": best, "mpaths_per_s": W * H * spp / best / 1e6,
           "kernel_ms": kernel_ms(scene, renderer, spp, depth, walk), "peak_mib": peak}
    if not bool(torch.isfinite(fb).all()):
        raise AssertionError(f"{scene.name} under {walk}: framebuffer is not finite")
    if ref_fb is not None:
        out["pixels_differ"] = int((fb != ref_fb).any(-1).sum().item())
        out["max_abs_diff"] = float((fb - ref_fb).abs().max().item())
    return out, fb


def sweep(log=print, spans=SPANS, walks=WALKS) -> dict:
    """Every (scene, span, walk) cell, uni too on ``UNI_SCENES``, and the
    JAX-span reference cell; {scene: {"ref": record, "cells": {"span,walk":
    record}}}."""
    out = {}
    for name, (spp, depth, jax_span) in SCENES.items():
        ref, ref_fb = cell(load(name, jax_span), spp, depth, "cond")
        log(f"sweep {name} JAX span {jax_span}, cond: {ref['mpaths_per_s']:.2f} Mpaths/s, "
            f"kernel {ref['kernel_ms']:.3f} ms, peak {ref['peak_mib']:.1f} MiB")
        cells = {}
        for span in spans:
            per_kind = load(name, span)
            uni = load(name, span, walk="uni") if name in UNI_SCENES else None
            for walk in walks + (("uni",) if uni else ()):
                scene = uni if walk == "uni" else per_kind
                trees = ("uni",) if walk == "uni" else ("sph", "quad")
                nodes = [getattr(scene.compiled, f"{k}_tree_box").shape[0] for k in trees
                         if getattr(scene.compiled, f"has_{k}_tree")]
                rec, _ = cell(scene, spp, depth, walk, ref_fb)
                rec["tree_nodes"] = nodes
                cells[f"{span},{walk}"] = rec
                log(f"sweep {name} span {span} ({nodes} nodes), {walk}: "
                    f"{rec['mpaths_per_s']:.2f} Mpaths/s, kernel {rec['kernel_ms']:.3f} ms, "
                    f"peak {rec['peak_mib']:.1f} MiB, pixels differing from the JAX-span cond "
                    f"render {rec['pixels_differ']} (max |diff| {rec['max_abs_diff']:.3e})")
        out[name] = {"jax_span": jax_span, "ref": ref, "cells": cells, "ref_fb": ref_fb}
    return out


def lut_cell(span, walk, ref_fb, log=print) -> dict:
    """rtw_final with a native-budget texture LUT (the render kernel) at
    ``span`` under ``walk``, against the atlas reference framebuffer."""
    spp, depth, _ = SCENES["rtw_final"]
    rec, _ = cell(load("rtw_final", span, LUT_NATIVE, walk), spp, depth, walk, ref_fb)
    log(f"sweep rtw_final LUT span {span}, {walk}: {rec['mpaths_per_s']:.2f} Mpaths/s, kernel "
        f"{rec['kernel_ms']:.3f} ms, pixels differing from the JAX-span cond atlas render "
        f"{rec['pixels_differ']}")
    return rec


def pairs(name, settings, n=5, log=print) -> dict:
    """``n`` alternating pairs of two settings of scene ``name``, each a
    (label, span or None, walk or None) and each side of a pair the best of
    three renders; the order flips every pair.  Returns the times, the
    wins of the first setting and the medians."""
    spp, depth, _ = SCENES[name]
    scenes = [load(name, span, walk=walk) for _, span, walk in settings]
    for scene, (_, _, walk) in zip(scenes, settings):
        render_best(scene, spp, depth, walk, reps=1)  # warm both plans
    times = []
    for i in range(n):
        order = (0, 1) if i % 2 == 0 else (1, 0)
        t = [0.0, 0.0]
        for j in order:
            t[j] = render_best(scenes[j], spp, depth, settings[j][2])[0]
        times.append(tuple(t))
    wins = sum(a < b for a, b in times)
    med = [sorted(ts)[n // 2] for ts in zip(*times)]
    labels = [s[0] for s in settings]
    log(f"pairs {name}: {labels[0]} vs {labels[1]}, {n} alternating pairs: {labels[0]} faster "
        f"in {wins}; medians {med[0]:.4f} vs {med[1]:.4f} s "
        f"({W * H * spp / med[0] / 1e6:.2f} vs {W * H * spp / med[1] / 1e6:.2f} Mpaths/s); "
        f"pairs {[(round(a, 4), round(b, 4)) for a, b in times]}")
    return {"labels": labels, "times_s": times, "first_wins": wins, "medians_s": med}


def uni_pairs(log=print) -> dict:
    """The unified tree's walk against the default queue walk on rtw_final
    at the package's leaf span, in alternating pairs."""
    return pairs("rtw_final", (("uni", None, "uni"), ("queue", None, "queue")), log=log)


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("span_sweep: CUDA is not available", file=sys.stderr)
        return 2
    log = lambda m: print(m, flush=True)
    res = sweep(log)
    best = {name: max(r["cells"].items(), key=lambda kv: kv[1]["mpaths_per_s"])[0]
            for name, r in res.items()}
    span, walk = best["rtw_final"].split(",")
    lut = lut_cell(int(span), walk, res["rtw_final"]["ref_fb"], log)
    pr = {}
    for name, key in best.items():
        span = int(key.split(",")[0])
        pr[name] = pairs(name, (("cond", span, "cond"), ("queue", span, "queue")), log=log)
    pr["rtw_final uni"] = uni_pairs(log)
    for r in res.values():
        r.pop("ref_fb")
    print(json.dumps({"device": torch.cuda.get_device_name(0), "sweep": res, "best": best,
                      "lut": lut, "pairs": pr}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
