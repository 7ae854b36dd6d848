"""The texture LUT's image delta (counterpart of the JAX package's
``tools/lut_quality.py``): a scene rendered with the exact atlas fetch and
with the texture LUT at one or more texel budgets, and the framebuffers'
difference statistics.

    python -m zig_weekend_raytracer_tpu_torch.tools.lut_quality <scene> [budget ...]
        [--spp=N] [--size=N] [--depth=N] [--device=cuda|cpu]
    (defaults: shrek_quads, budgets 8192 32768; spp 64; 400x400 depth 10)

The comparison is in linear space on the raw framebuffers (no writer gamma
round trip), against the exact render of the same sample count and seed,
so the delta isolates the texture downsampling bias from Monte-Carlo
noise.  Each budget's row goes to stderr, the summary line to stdout.  The
budget is passed to the scene compile (``load_scene(texture_lut=)``); the
environment is left as it is.  ``--device=cpu`` runs the kernels' plain
versions (for the tests); without a card the default exits 1.
"""

from __future__ import annotations

import json
import sys

import numpy as np

from . import card_missing


def render(scene_name: str, budget: int, spp: int, size: int, depth: int, device="cuda"):
    """(framebuffer on the host, whether the scene packed a texture LUT) of
    a fresh scene compile at ``budget`` texels (0: the exact atlas fetch)."""
    from ..models import load_scene
    from ..render.renderer import Renderer

    scene = load_scene(scene_name, device=device, texture_lut=budget)
    r = Renderer(samples_per_pixel=spp, max_ray_bounce_depth=depth)
    fb = r.render_device(scene, size, size).cpu().numpy()
    return fb, bool(scene.compiled.tex_lut_dims)


def row(budget: int, exact: np.ndarray, fb: np.ndarray, lut_active: bool) -> dict:
    """One budget's statistics against the exact render; the PSNR's peak is
    the exact render's maximum, at least 1."""
    d = fb - exact
    mse = float((d * d).mean())
    return {
        "budget": budget,
        "lut_active": lut_active,
        "mse_vs_exact": round(mse, 8),
        "psnr_db": round(
            10 * np.log10(max(float(exact.max()), 1.0) ** 2 / mse), 2
        ) if mse > 0 else None,
        "max_abs": round(float(np.abs(d).max()), 6),
        "mean_exact": round(float(exact.mean()), 6),
        "mean_lut": round(float(fb.mean()), 6),
    }


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = [a for a in argv if not a.startswith("--")]
    flags = dict(a.lstrip("-").split("=", 1) for a in argv if a.startswith("--"))
    scene = args[0] if args else "shrek_quads"
    budgets = [int(a) for a in args[1:]] or [8192, 32768]
    spp = int(flags.get("spp", 64))
    size = int(flags.get("size", 400))
    depth = int(flags.get("depth", 10))
    device = flags.get("device", "cuda")
    if card_missing(device, "lut_quality"):
        return 1

    exact, had_lut = render(scene, 0, spp, size, depth, device)
    if had_lut:
        raise AssertionError(f"{scene}: the exact render packed a texture LUT")
    rows = []
    for budget in budgets:
        fb, got_lut = render(scene, budget, spp, size, depth, device)
        rows.append(row(budget, exact, fb, got_lut))
        print(json.dumps(rows[-1]), file=sys.stderr, flush=True)
    print(json.dumps({"scene": scene, "spp": spp, "size": size,
                      "depth": depth, "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
