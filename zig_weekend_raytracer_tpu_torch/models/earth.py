"""Textured spheres: the earth globe over a checkered ground, with a fuzzy
metal ball (counterpart of ``models/earth.py``, constant for constant)."""

from __future__ import annotations

import os

from ..io.image import load_image
from ..scene import Camera, Scene, SceneBuilder


def load_scene_earth(seed: int = 0, asset_dir: str = "", device="cuda",
                     texture_lut=None) -> Scene:
    b = SceneBuilder()

    checker = b.checkerboard(
        1.0 / 3.1,
        b.solid_color((0.2, 0.3, 0.1)),
        b.solid_color((0.9, 0.9, 0.9)),
    )
    ground = b.lambertian(checker)
    b.add(b.sphere((0, -1000, 0), 1000.0, ground))

    earth = b.lambertian(
        b.image_texture(load_image(os.path.join(asset_dir, "earth.png")))
    )
    b.add(b.sphere((0, 2, 0), 2.0, earth))

    mirror = b.metal((0.8, 0.8, 0.9), 0.05)
    b.add(b.sphere((-4.5, 1, 1.5), 1.0, mirror))

    b.set_background((0.70, 0.80, 1.00))
    b.set_camera(
        Camera(
            look_from=(13, 3, 3),
            look_at=(0, 2, 0),
            view_up=(0, 1, 0),
            vfov_degrees=25.0,
            focus_dist=10.0,
            defocus_angle_degrees=0.0,
        )
    )
    return b.compile(name="earth", device=device, texture_lut=texture_lut)
