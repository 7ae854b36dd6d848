"""Quality and cost of adaptive sampling and the denoiser at production
resolution (counterpart of the JAX package's ``tools/quality_prodres.py``).

    python -m zig_weekend_raytracer_tpu_torch.tools.quality_prodres [scene ...]
        [--size=N] [--spp=8,32] [--seeds=3] [--ref_spp=512] [--device=cuda|cpu]

For each scene (default cornell_box and balls) and spp: the MSE, in
float64 on the host, against a reference render of ``ref_spp`` samples at
seed 999 on the same device, of four pipelines pooled over the seeds:
uniform, adaptive (same budget), uniform + AOV pass + denoiser, and
adaptive + the same; and each pipeline's median wall time.  A pipeline's
time holds its renders' copies to the host, as the JAX tool's does, and
the AOV pass (4 spp) and the filter; every interval ends with
``torch.cuda.synchronize()``.  Prints one JSON line per (scene, spp), then
a summary line.  ``--device=cpu`` runs the kernels' plain versions (for the
tests); without a card the default exits 1.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

from . import card_missing, synchronizer

PIPELINES = ("uniform", "adaptive", "denoise", "both")


def _mse(a, b):
    return float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = [a for a in argv if not a.startswith("--")]
    opts = dict(a[2:].split("=", 1) if "=" in a else (a[2:], "1")
                for a in argv if a.startswith("--"))
    scenes = args or ["cornell_box", "balls"]
    size = int(opts.get("size", 400))
    spps = [int(s) for s in opts.get("spp", "8,32").split(",")]
    n_seeds = int(opts.get("seeds", 3))
    ref_spp = int(opts.get("ref_spp", 512))
    device = opts.get("device", "cuda")
    if card_missing(device, "quality_prodres"):
        return 1

    from ..models import load_scene
    from ..render.aov import render_aovs
    from ..render.denoise import denoise
    from ..render.renderer import Renderer

    sync = synchronizer(device)
    results = []
    for scene_name in scenes:
        scene = load_scene(scene_name, device=device)
        ref = Renderer(samples_per_pixel=ref_spp, max_ray_bounce_depth=10,
                       seed=999).render_device(scene, size, size).cpu().numpy()
        for spp in spps:
            mses = {k: [] for k in PIPELINES}
            times = {k: [] for k in PIPELINES}
            for seed in range(n_seeds):
                r = Renderer(samples_per_pixel=spp, max_ray_bounce_depth=10, seed=seed)
                t0 = time.perf_counter()
                dev_u = r.render_device(scene, size, size)
                fb_u = dev_u.cpu().numpy()
                sync()
                t_uniform = time.perf_counter() - t0
                t0 = time.perf_counter()
                dev_a = r.render_adaptive(scene, size, size)
                fb_a = dev_a.cpu().numpy()
                sync()
                t_adaptive = time.perf_counter() - t0
                t0 = time.perf_counter()
                aovs = render_aovs(scene, size, size, seed=seed)
                sync()
                t_aov = time.perf_counter() - t0
                t0 = time.perf_counter()
                fb_ud = denoise(dev_u, aovs).cpu().numpy()
                sync()
                t_filter = time.perf_counter() - t0
                fb_ad = denoise(dev_a, aovs).cpu().numpy()
                times["uniform"].append(t_uniform)
                times["adaptive"].append(t_adaptive)
                times["denoise"].append(t_uniform + t_aov + t_filter)
                times["both"].append(t_adaptive + t_aov + t_filter)
                for k, fb in (("uniform", fb_u), ("adaptive", fb_a),
                              ("denoise", fb_ud), ("both", fb_ad)):
                    mses[k].append(_mse(fb, ref))
            base = float(np.mean(mses["uniform"]))
            row = {
                "scene": scene_name, "size": size, "spp": spp,
                "seeds": n_seeds, "ref_spp": ref_spp,
                "mse_uniform": round(base, 6),
                "mse_ratio": {
                    k: round(float(np.mean(v)) / base, 4)
                    for k, v in mses.items()
                },
                "wall_s": {
                    k: round(float(np.median(v)), 3)
                    for k, v in times.items()
                },
            }
            results.append(row)
            print(json.dumps(row), flush=True)
    print(json.dumps({"summary": "quality_prodres", "rows": len(results)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
