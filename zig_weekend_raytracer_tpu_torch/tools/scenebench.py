"""Per-scene steady-state throughput on the card (counterpart of the JAX
package's ``tools/scenebench.py``).

    python -m zig_weekend_raytracer_tpu_torch.tools.scenebench <scene> [w] [h] [spp]
        [depth] [reps] [--rr=N] [--clamp=X] [--adaptive[=pilot]] [--denoise=N]
        [--shard=samples|rows] [--supersample=K] [--device=cuda|cpu]

One warm run (it builds the kernels the first time, and the render's lane
plan), then the best of ``reps`` runs, each ended by
``torch.cuda.synchronize()``.  The optional flags benchmark the
beyond-reference features: Russian roulette from bounce N, the indirect
clamp, adaptive sampling at the same budget, sharding over every card, the
supersampled render, and the AOV-guided denoiser (its AOV pass and filter
timed apart, cold and then the best of ``reps``).  Prints the JAX tool's
lines.  ``--device=cpu`` runs the kernels' plain versions (for the tests);
without a card the default exits 1.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from . import card_missing, synchronizer

FLAGS = ("rr", "clamp", "adaptive", "denoise", "shard", "supersample", "device")


def parse(argv, flags=FLAGS):
    """(positional arguments, {flag: value}) with the JAX tool's checks and
    messages; a bare ``--flag`` is "1"; ``flags`` are the flags taken."""
    args = [a for a in argv if not a.startswith("--")]
    opts = dict(a[2:].split("=", 1) if "=" in a else (a[2:], "1")
                for a in argv if a.startswith("--"))
    unknown = set(opts) - set(flags)
    if unknown:
        raise SystemExit(
            f"unknown flags {sorted(unknown)} "
            f"(valid: {' '.join('--' + f for f in flags)})"
        )
    return args, opts


def bench(argv) -> dict:
    """Runs the benchmark that ``argv`` asks for and prints its lines;
    returns the last framebuffer (``fb``) and, with ``--denoise``, the
    denoised one (``denoised``), as tensors on the device."""
    args, opts = parse(argv)
    scene_name = args[0] if len(args) > 0 else "cornell_box"
    width = int(args[1]) if len(args) > 1 else 400
    height = int(args[2]) if len(args) > 2 else 400
    spp = int(args[3]) if len(args) > 3 else 128
    depth = int(args[4]) if len(args) > 4 else 10
    reps = int(args[5]) if len(args) > 5 else 3
    rr = int(opts.get("rr", 0))
    clamp = float(opts.get("clamp", 0.0))
    adaptive = int(opts.get("adaptive", 0))
    denoise_iters = int(opts.get("denoise", 0))
    shard = opts.get("shard", "")  # samples | rows (device-count = all)
    if shard and shard not in ("samples", "rows"):
        raise SystemExit(
            f"--shard={shard!r}: expected 'samples' or 'rows'"
        )
    supersample = int(opts.get("supersample", 1))
    if supersample > 1 and (adaptive or shard):
        raise SystemExit("--supersample combines only with plain renders")
    device = opts.get("device", "cuda")

    from ..models import load_scene
    from ..parallel import make_mesh, render_adaptive_sharded, render_sharded
    from ..render.renderer import Renderer

    sync = synchronizer(device)
    scene = load_scene(scene_name, device=device)
    renderer = Renderer(
        samples_per_pixel=spp, max_ray_bounce_depth=depth,
        russian_roulette=rr, clamp_indirect=clamp,
    )
    mesh = make_mesh(device=device) if shard else None
    pilot = adaptive if adaptive >= 2 else 0

    def run():
        if adaptive and shard:
            out = render_adaptive_sharded(
                scene, width, height, spp, max_depth=depth, mesh=mesh,
                shard=shard, rr=rr, clamp=clamp, pilot_spp=pilot,
            )
        elif adaptive:
            out = renderer.render_adaptive(scene, width, height, pilot_spp=pilot)
        elif shard:
            out = render_sharded(
                scene, width, height, spp, max_depth=depth, mesh=mesh,
                shard=shard, rr=rr, clamp=clamp,
            )
        elif supersample > 1:
            out = renderer.render_supersampled(scene, width, height, k=supersample)
        else:
            out = renderer.render_device(scene, width, height)
        sync()
        return out

    t0 = time.perf_counter()
    fb = run()
    warm = time.perf_counter() - t0

    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fb = run()
        best = min(best, time.perf_counter() - t0)

    fb_host = fb.cpu().numpy()
    nan = bool(np.isnan(fb_host).any())
    mpaths = width * height * spp / best / 1e6
    tag = "".join(
        [f" rr={rr}" if rr else "", f" clamp={clamp}" if clamp else "",
         " adaptive" if adaptive else "",
         f" shard={shard}" if shard else "",
         f" ss={supersample}" if supersample > 1 else ""]
    )
    print(
        f"{scene_name} {width}x{height}@{spp}spp d{depth}{tag}: "
        f"best {best:.3f}s ({mpaths:.1f} Mpaths/s), warm {warm:.1f}s, "
        f"nan={nan}, mean={fb_host.mean():.4f}", flush=True,
    )
    out = {"fb": fb, "denoised": None}

    if denoise_iters:
        from ..render.aov import render_aovs
        from ..render.denoise import denoise

        def aov_pass():
            aovs = render_aovs(scene, width, height, seed=renderer.seed)
            sync()
            return aovs

        def filter_pass(aovs):
            dn = denoise(fb, aovs, iterations=denoise_iters)
            sync()
            return dn

        # the cold call first, then the best of reps for the steady state
        t0 = time.perf_counter()
        dn = filter_pass(aov_pass())
        t_cold = time.perf_counter() - t0
        best_aov = best_dn = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            aovs = aov_pass()
            best_aov = min(best_aov, time.perf_counter() - t0)
            t0 = time.perf_counter()
            dn = filter_pass(aovs)
            best_dn = min(best_dn, time.perf_counter() - t0)
        print(
            f"  denoise({denoise_iters}): aov pass {best_aov:.3f}s + filter "
            f"{best_dn:.3f}s steady (cold total {t_cold:.1f}s), "
            f"mean={dn.cpu().numpy().mean():.4f}", flush=True,
        )
        out["denoised"] = dn
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if card_missing(parse(argv)[1].get("device", "cuda"), "scenebench"):
        return 1
    bench(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
