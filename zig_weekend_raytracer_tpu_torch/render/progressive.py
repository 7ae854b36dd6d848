"""Progressive rendering with checkpoint / resume (counterpart of
``render/progressive.py``).

Each batch of samples is an independent estimator, so the framebuffer's
sum and the count of samples done are the whole checkpoint: a plain
``.npz`` (``fb_sum`` float32, ``samples_done``, ``total_spp``,
``fingerprint``).  The content-addressed RNG makes a resumed render
bitwise the uninterrupted one.  A batch renders its sample range through
``parallel/render.py:render_batch_sharded`` with the render's total spp,
so the samplers see the geometry of one uninterrupted render: on a mesh
of the scene's own device, or with ``shard`` across ``mesh``.  So the
render kernel runs (the bounce kernel's regenerating mode on atlas
scenes), and brute scenes at one sample in flight per pixel follow the
cost-sorted plan from their second batch on.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Callable, Optional

import numpy as np

from ..parallel import SHARD_MODES, render_batch_sharded, resolve_mesh
from ..scene import Scene
from .renderer import Renderer

log = logging.getLogger("zwrt")


def _fingerprint(scene: Scene, width, height, renderer: Renderer) -> str:
    """The checkpoint's key, the JAX package's string for the same
    settings: every Renderer field that changes the estimator, and every
    one that changes the band and sample decomposition (the estimator does
    not depend on it, the float32 sums' order does)."""
    return (
        f"{scene.name}:{width}x{height}:depth{renderer.max_ray_bounce_depth}"
        f":{renderer.sampler.value}:seed{renderer.seed}"
        f":rr{renderer.russian_roulette}:clamp{renderer.clamp_indirect}"
        f":chunk{renderer.max_rays_per_chunk}-{renderer.max_rays_per_chunk_bvh}"
        f"-{renderer.regen_min_wave}"
    )


@dataclasses.dataclass
class ProgressiveRenderer:
    """Renders in sample batches, writing the checkpoint after every
    ``checkpoint_every`` batches and after the last.  ``shard`` ("samples"
    or "rows", as ``render_sharded`` takes it) renders each batch across
    ``mesh`` (default: ``make_mesh`` of the scene's device type); the
    fingerprint then names the mode and the mesh size, whose float32 sums
    differ, so a checkpoint of another mesh size is not resumed."""

    renderer: Renderer
    checkpoint_path: str
    checkpoint_every: int = 1
    shard: str = "none"  # none | samples | rows
    mesh: Optional[tuple] = None

    def __post_init__(self):
        if self.shard != "none" and self.shard not in SHARD_MODES:
            raise ValueError(f"unknown shard mode: {self.shard}")

    def render(self, scene: Scene, width: int, height: int, batch_spp: int = 16,
               on_batch: Optional[Callable[[int, np.ndarray], None]] = None) -> np.ndarray:
        """Renders ``renderer.samples_per_pixel`` samples in batches of
        ``batch_spp``, resuming from the checkpoint when its fingerprint and
        total match; returns the averaged (H, W, 3) float32 framebuffer."""
        total_spp = self.renderer.samples_per_pixel
        fp = _fingerprint(scene, width, height, self.renderer)
        if self.shard == "none":
            mesh, shard = (scene.compiled.device,), "samples"
        else:
            mesh, shard = resolve_mesh(self.mesh, scene.compiled.device), self.shard
            fp += f":shard-{shard}-{len(mesh)}"
        fb_sum = np.zeros((height, width, 3), np.float32)
        done = 0
        if os.path.exists(self.checkpoint_path):
            z = np.load(self.checkpoint_path, allow_pickle=False)
            if str(z["fingerprint"]) == fp and int(z["total_spp"]) == total_spp:
                fb_sum = z["fb_sum"].astype(np.float32)
                done = int(z["samples_done"])
                log.info("resuming render from checkpoint: %d/%d spp done", done, total_spp)
            else:
                log.warning("checkpoint fingerprint mismatch; starting fresh")

        batch_idx = 0
        while done < total_spp:
            spp_now = min(batch_spp, total_spp - done)
            r = self.renderer
            batch = render_batch_sharded(
                scene, width, height, total_spp, done, spp_now,
                max_depth=r.max_ray_bounce_depth, sampler=r.sampler, mesh=mesh, shard=shard,
                seed=r.seed, max_rays_per_chunk=r.max_rays_per_chunk, rr=r.russian_roulette,
                clamp=r.clamp_indirect, regen_min_wave=r.regen_min_wave,
            )
            fb_sum += batch.cpu().numpy()
            done += spp_now
            batch_idx += 1
            if batch_idx % self.checkpoint_every == 0 or done >= total_spp:
                self._save(fb_sum, done, total_spp, fp)
            if on_batch is not None:
                on_batch(done, fb_sum / max(done, 1))
        return fb_sum / total_spp

    def _save(self, fb_sum, done, total_spp, fp) -> None:
        tmp = self.checkpoint_path + ".tmp.npz"
        np.savez(tmp, fb_sum=fb_sum, samples_done=done, total_spp=total_spp, fingerprint=fp)
        os.replace(tmp, self.checkpoint_path)  # atomic swap
