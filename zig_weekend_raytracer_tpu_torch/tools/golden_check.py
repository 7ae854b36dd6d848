"""The region gate of every golden scene on the card.

    python -m zig_weekend_raytracer_tpu_torch.tools.golden_check [scene ...]

Renders each scene of ``tests/golden/scene_regions.json`` (default: all)
through ``Renderer.render_device`` at that file's configuration (its width,
height, spp and depth, seed 0) and holds the framebuffer to the file's
region statistics with ``utils/goldengate.py``: the global mean within 1%,
no region past 10% and 5e-3, at most 5 regions past 2% and 1e-3.  Prints
one line per scene; exits 0 when every scene passes, 1 when one fails or
there is no card, 2 on a scene the file does not have.

``--device=cpu`` renders with the kernels' plain versions; it exists for
the tests, which gate a cut size on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REGIONS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__)))), "tests", "golden", "scene_regions.json")


def check_scene(name: str, ref: dict, device: str) -> str:
    """The gate's verdict on ``name`` rendered at ``ref``'s configuration."""
    from ..models import load_scene
    from ..render.renderer import Renderer
    from ..utils.goldengate import check_framebuffer

    scene = load_scene(name, device=device)
    fb = Renderer(samples_per_pixel=ref["spp"], max_ray_bounce_depth=ref["depth"],
                  seed=0).render(scene, ref["width"], ref["height"])
    return check_framebuffer(fb, ref["mean"], np.asarray(ref["region_means"]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("scenes", nargs="*")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    with open(REGIONS) as f:
        golden = json.load(f)["scenes"]
    names = args.scenes or list(golden)
    unknown = [n for n in names if n not in golden]
    if unknown:
        print(f"error: unknown scene(s) {unknown}; the file has {sorted(golden)}",
              file=sys.stderr)
        return 2
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: CUDA is not available: the gate renders on the card", file=sys.stderr)
        return 1
    where = torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"
    rc = 0
    for name in names:
        ref = golden[name]
        t0 = time.perf_counter()
        verdict = check_scene(name, ref, args.device)
        print(f"{name}: {verdict} ({ref['width']}x{ref['height']}@{ref['spp']} "
              f"d{ref['depth']}, {time.perf_counter() - t0:.2f} s on {where})", flush=True)
        if not verdict.startswith("pass"):
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
