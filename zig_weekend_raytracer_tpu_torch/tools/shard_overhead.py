"""Sharding's cost on one card (counterpart of the JAX package's
``tools/shard_overhead.py``).

    python -m zig_weekend_raytracer_tpu_torch.tools.shard_overhead [w] [h] [spp] [depth]
        [reps] [--device=cuda|cpu]

Renders cornell_box through ``Renderer.render_device`` and through
``parallel.render_sharded`` on a one-device mesh (``make_mesh(1)``) in both
modes, each the best of ``reps`` runs after one warm run, every run ended
by ``torch.cuda.synchronize()``.  The ratios price the sharded path's own
work (the mesh loop, per-device windows or row blocks, the reduce) with no
second device.  Prints one JSON line with the JAX tool's keys; exits 1 when
a sharded render disagrees with the direct one (atol 1e-5), and 1 without a
card unless ``--device=cpu`` (the kernels' plain versions, for the tests).
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

from . import card_missing, synchronizer


def _time_best(fn, reps, sync):
    """(best seconds of ``reps`` runs after a warm one, the last result on
    the host)."""
    out = fn()
    sync()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        sync()
        best = min(best, time.perf_counter() - t0)
    return best, out.cpu().numpy()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = [a for a in argv if not a.startswith("--")]
    opts = dict(a[2:].split("=", 1) if "=" in a else (a[2:], "1")
                for a in argv if a.startswith("--"))
    if set(opts) - {"device"}:
        raise SystemExit(f"unknown flags {sorted(set(opts) - {'device'})} (valid: --device)")
    device = opts.get("device", "cuda")
    width = int(args[0]) if len(args) > 0 else 400
    height = int(args[1]) if len(args) > 1 else 400
    spp = int(args[2]) if len(args) > 2 else 1024
    depth = int(args[3]) if len(args) > 3 else 10
    reps = int(args[4]) if len(args) > 4 else 3
    if card_missing(device, "shard_overhead"):
        return 1

    from ..models import load_scene
    from ..parallel import make_mesh, render_sharded
    from ..render.renderer import Renderer

    sync = synchronizer(device)
    scene = load_scene("cornell_box", device=device)
    renderer = Renderer(samples_per_pixel=spp, max_ray_bounce_depth=depth)
    mesh = make_mesh(1, device=device)

    t_direct, fb_direct = _time_best(
        lambda: renderer.render_device(scene, width, height), reps, sync)
    t_samples, fb_samples = _time_best(
        lambda: render_sharded(scene, width, height, spp, max_depth=depth,
                               mesh=mesh, shard="samples"), reps, sync)
    t_rows, fb_rows = _time_best(
        lambda: render_sharded(scene, width, height, spp, max_depth=depth,
                               mesh=mesh, shard="rows"), reps, sync)

    # One device's shards are the unsharded render's bands (content-addressed
    # RNG): a mismatch means the sharded path left the direct one.
    agree_samples = bool(np.allclose(fb_direct, fb_samples, atol=1e-5))
    agree_rows = bool(np.allclose(fb_direct, fb_rows, atol=1e-5))

    print(json.dumps({
        "config": f"cornell_box {width}x{height}@{spp}spp d{depth} (1-dev mesh)",
        "direct_s": round(t_direct, 4),
        "sharded_samples_s": round(t_samples, 4),
        "sharded_rows_s": round(t_rows, 4),
        "overhead_samples": round(t_samples / t_direct - 1.0, 4),
        "overhead_rows": round(t_rows / t_direct - 1.0, 4),
        "agree_samples": agree_samples,
        "agree_rows": agree_rows,
    }), flush=True)
    return 0 if agree_samples and agree_rows else 1


if __name__ == "__main__":
    sys.exit(main())
