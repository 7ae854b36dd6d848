"""Progressive rendering with checkpoint / resume (counterpart of
``render/progressive.py``).

Each batch of samples is an independent estimator, so the framebuffer's
sum and the count of samples done are the whole checkpoint: a plain
``.npz`` (``fb_sum`` float32, ``samples_done``, ``total_spp``,
``fingerprint``).  The content-addressed RNG makes a resumed render
bitwise the uninterrupted one.  A batch renders its sample range through
``renderer._render_band_regen`` (the render kernel, or the bounce kernel's
regenerating mode on atlas scenes) with the render's total spp, so the
samplers see the geometry of one uninterrupted render.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Callable, Optional

import numpy as np
import torch

from ..dtypes import real
from ..scene import Scene
from .camera import camera_consts
from .renderer import Renderer, _render_band_regen

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
    ``checkpoint_every`` batches and after the last.  ``shard`` other than
    "none" (batches across devices) is a later slice of the port."""

    renderer: Renderer
    checkpoint_path: str
    checkpoint_every: int = 1
    shard: str = "none"

    def __post_init__(self):
        if self.shard != "none":
            raise NotImplementedError(
                f"ProgressiveRenderer(shard={self.shard!r}): sharded batches are slice 6 of "
                "the port (ROADMAP.md); use shard='none'"
            )

    def render(self, scene: Scene, width: int, height: int, batch_spp: int = 16,
               on_batch: Optional[Callable[[int, np.ndarray], None]] = None) -> np.ndarray:
        """Renders ``renderer.samples_per_pixel`` samples in batches of
        ``batch_spp``, resuming from the checkpoint when its fingerprint and
        total match; returns the averaged (H, W, 3) float32 framebuffer."""
        total_spp = self.renderer.samples_per_pixel
        fp = _fingerprint(scene, width, height, self.renderer)
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
            fb_sum += _render_batch(self.renderer, scene, width, height, done,
                                    spp_now).cpu().numpy()
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


def _render_batch(renderer: Renderer, scene: Scene, width, height, sample0: int,
                  spp_now: int) -> torch.Tensor:
    """The radiance sum over samples [sample0, sample0 + spp_now), (H, W, 3)
    on the scene's device."""
    cs = scene.compiled
    total_spp = renderer.samples_per_pixel
    s_par, band_rows = renderer.regen_geometry(width, height, spp_now)
    n_bands = -(-height // band_rows)
    fb = torch.zeros((n_bands * band_rows, width, 3), dtype=real, device=cs.device)
    cam_c = camera_consts(scene.camera, width, height)
    for b in range(n_bands):
        y0 = b * band_rows
        fb[y0 : y0 + band_rows] += _render_band_regen(
            scene, renderer.seed, y0, sample0, width=width, height=height,
            band_rows=band_rows, s_par=s_par, spp=total_spp,
            sample_limit=min(sample0 + spp_now, total_spp),
            max_depth=renderer.max_ray_bounce_depth, sampler=renderer.sampler,
            has_dof=scene.camera.has_depth_of_field, cam_consts=cam_c,
            rr=renderer.russian_roulette, clamp=renderer.clamp_indirect,
        )
    return fb[:height]
