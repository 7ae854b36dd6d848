"""Whether what a run's timed path produced is correct.

Every request of a run renders a new image: its render seed is
``request_seed(run seed, request index)``, so no two requests of a run,
warm-up included, ask for the same work.  The harness keeps the output
of ``check_requests`` requests drawn from the run seed by reservoir
sampling over every request of the run (``Keeper``: a reference to the
output tensor, nothing else, while a window runs), and gathers their
values at one pixel drawn from the run seed in each ``check_block`` x
``check_block`` tile (``pixel_sample``) once the windows have closed.
With the program's state freed, the reference (``benchmark/reference``,
plain PyTorch, float32) works out the same pixels of each kept request
from the same scene file at that request's own seed, every sample of
each, in lanes of sample chunks, and ``check`` compares:

  * ``img_mean_rel``: the worst kept request's mean |program - reference|
    over the checked pixels and channels, over the reference's mean
    |value|;
  * ``img_max_rel``: the worst kept request's largest |program -
    reference|, over the same mean.

A request fails when one of its own numbers is over its limit; the limits
are the traffic mix's ``limits``.
"""

from __future__ import annotations

import contextlib
import importlib

import numpy as np
import torch

REFERENCE = "benchmark.reference"
_MASK64 = (1 << 64) - 1


def request_seed(run_seed: int, index: int) -> int:
    """The render seed (32 bits) of request ``index`` of the run seeded
    ``run_seed``: a SplitMix64 finaliser over both, so that nearby run
    seeds and indices give unrelated render seeds."""
    z = (int(run_seed) * 0x9E3779B97F4A7C15 + (int(index) + 1) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & 0xFFFFFFFF


def pixel_sample(seed: int, width: int, height: int, block: int):
    """(xs, ys) int64 arrays: one pixel drawn from ``seed`` in each block x
    block tile of the image, row-major over the tiles."""
    rng = np.random.default_rng([int(seed), 0x5EED])
    y0, x0 = np.meshgrid(np.arange(0, height, block), np.arange(0, width, block),
                         indexing="ij")
    hy = np.minimum(block, height - y0)
    hx = np.minimum(block, width - x0)
    ys = y0 + np.floor(rng.random(y0.shape) * hy).astype(np.int64)
    xs = x0 + np.floor(rng.random(x0.shape) * hx).astype(np.int64)
    return xs.reshape(-1), ys.reshape(-1)


class Keeper:
    """The outputs of ``n_keep`` requests of a run, drawn from ``seed`` by
    reservoir sampling (Algorithm R) over every request offered: while a
    window runs it holds references only, and ``gather`` reads their
    checked pixels once the windows have closed."""

    def __init__(self, seed: int, n_keep: int):
        self.n_keep = n_keep
        self.kept = []           # [(request index, render seed, output)]
        self.seen = 0
        self._rng = np.random.default_rng([int(seed), 0xF011])

    def offer(self, index: int, render_seed: int, image) -> None:
        entry = (index, render_seed, image)
        if len(self.kept) < self.n_keep:
            self.kept.append(entry)
        else:
            j = int(self._rng.integers(0, self.seen + 1))
            if j < self.n_keep:
                self.kept[j] = entry
        self.seen += 1

    def gather(self, xs, ys) -> list:
        """[(render seed, (n, 3) float32 CPU tensor)] of the kept requests
        at pixels (xs, ys), in request order; the images are let go."""
        out = []
        for _, render_seed, image in sorted(self.kept, key=lambda e: e[0]):
            iy = torch.as_tensor(ys, device=image.device)
            ix = torch.as_tensor(xs, device=image.device)
            out.append((render_seed, image[iy, ix].to("cpu", torch.float32)))
        self.kept = []
        return out


def reference_scene(config_path: str, device, package: str = REFERENCE):
    scenefile = importlib.import_module(f"{package}.models.scenefile")
    return scenefile.load_scene_file(config_path, device=device)


def reference_pixels(scene, traffic: dict, render_seed: int, xs, ys, lanes: int = 1 << 20,
                     package: str = REFERENCE):
    """(n, 3) float64 radiance of pixels (xs, ys) averaged over every sample,
    rendered by the reference's integrator (of ``package``, the reference
    or its lower-precision copy) in lanes of sample chunks."""
    T_MIN = importlib.import_module(f"{package}.dtypes").T_MIN
    camera_consts = importlib.import_module(f"{package}.render.camera").camera_consts
    integrator = importlib.import_module(f"{package}.render.integrator")
    SamplerKind = importlib.import_module(f"{package}.sampling.sampler").SamplerKind

    width, height, spp = traffic["width"], traffic["height"], traffic["spp"]
    cs = scene.compiled
    dev = cs.device
    n_px = len(xs)
    chunk = -(-spp // max(1, min(spp, lanes // max(n_px, 1))))
    n_chunks = -(-spp // chunk)
    pix = np.repeat(np.arange(n_px), n_chunks)
    s0 = np.tile(np.arange(n_chunks) * chunk, n_px)
    s1 = np.minimum(s0 + chunk, spp)
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)
    total = torch.zeros((n_px, 3), dtype=torch.float64, device=dev)
    cam = camera_consts(scene.camera, width, height)
    for lo in range(0, pix.size, lanes):
        sl = slice(lo, lo + lanes)
        rad = integrator.render_fused_reference(
            cs, i32(xs[pix[sl]]), i32(ys[pix[sl]]), i32(s0[sl]), i32(s1[sl]), render_seed,
            T_MIN, camera_consts=cam, sampler=SamplerKind.SOBOL, width=width, height=height,
            spp=spp, stride=1, max_depth=traffic["depth"],
            has_dof=scene.camera.has_depth_of_field,
        )
        vals = torch.stack([rad.x, rad.y, rad.z], dim=-1).to(torch.float64)
        total.index_add_(0, torch.as_tensor(pix[sl], device=dev), vals)
    return total / spp


def rel_gaps(program, reference):
    """(mean |p - r|, max |p - r|), each over the reference's mean |r|, in
    float64."""
    p = program.to(torch.float64).cpu()
    r = reference.to(torch.float64).cpu()
    scale = max(float(r.abs().mean()), 1e-30)
    d = (p - r).abs()
    return float(d.mean()) / scale, float(d.max()) / scale


def check(traffic: dict, config_path: str, kept: list, xs, ys, device,
          count: bool = False) -> dict:
    """Compare the kept requests' pixels (``Keeper.gather``) with the
    reference at each request's seed.  Returns {"compared": {name: (value,
    limit)}, "failed": kept requests failing a limit, "counts": the
    reference's work counts over every checked pixel (with ``count``),
    "n_pixels": the pixels counted, "scene": the reference's scene}."""
    from .reference.utils import workcount

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    limits = traffic["limits"]
    scene = reference_scene(config_path, device)
    per_request = []
    with workcount.counting() if count else contextlib.nullcontext({}) as counts:
        for render_seed, pixels in kept:
            ref = reference_pixels(scene, traffic, render_seed, xs, ys)
            per_request.append(rel_gaps(pixels, ref))
    numbers = {
        "img_mean_rel": max(g[0] for g in per_request),
        "img_max_rel": max(g[1] for g in per_request),
    }
    failed = sum(g[0] > limits["img_mean_rel"] or g[1] > limits["img_max_rel"]
                 for g in per_request)
    compared = {k: (v, float(limits[k])) for k, v in numbers.items()}
    return {"compared": compared, "failed": failed, "counts": dict(counts) if count else None,
            "n_pixels": len(xs) * len(kept), "scene": scene}
