"""Book-1 final scene: a random sphere field on a checkered ground, seen
through a lens with depth of field (counterpart of ``models/balls.py``,
constant for constant and draw for draw).  ``balls_builder(seed,
inner_scale)`` nests a checker of the ground's two colours at
``inner_scale`` in the ground checker's even cells: the nested-checker
scene (``models/nested.py``)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..scene import Camera, Scene, SceneBuilder


def load_scene_balls(seed: int = 0, asset_dir: str = "", device="cuda",
                     texture_lut=None) -> Scene:
    return balls_builder(seed).compile(name="balls", device=device, texture_lut=texture_lut)


def balls_builder(seed: int = 0, inner_scale: Optional[float] = None) -> SceneBuilder:
    rand = np.random.default_rng(seed)
    b = SceneBuilder()

    tex_brown = b.solid_color((0.4, 0.2, 0.1))
    tex_even = b.solid_color((0.2, 0.3, 0.1))
    tex_odd = b.solid_color((0.9, 0.9, 0.9))
    if inner_scale is not None:
        tex_even = b.checkerboard(inner_scale, tex_even, tex_odd)
    tex_ground = b.checkerboard(0.32, tex_even, tex_odd)

    # ground
    b.add(b.sphere((0, -1000, 0), 1000, b.lambertian(tex_ground)))

    # the random 22 x 22 sphere grid
    for a in range(-11, 11):
        for bb in range(-11, 11):
            choose_mat = rand.random()
            center = np.array(
                [a + 0.9 * rand.random(), 0.2, bb + 0.9 * rand.random()]
            )
            if np.linalg.norm(center - np.array([4, 0.2, 0])) <= 0.9:
                continue
            if choose_mat < 0.8:
                albedo = rand.random(3)
                mat = b.lambertian(b.solid_color(albedo))
            elif choose_mat < 0.95:
                albedo = 0.5 + 0.5 * rand.random(3)
                mat = b.metal(albedo, rand.random() * 0.8)
            else:
                mat = b.dielectric(1.5)
            b.add(b.sphere(center, 0.2, mat))

    b.add(b.sphere((0, 1, 0), 1.0, b.dielectric(1.5)))
    b.add(b.sphere((-4, 1, 0), 1.0, b.lambertian(tex_brown)))
    b.add(b.sphere((4, 1, 0), 1.0, b.metal((0.7, 0.6, 0.5), 0.0)))

    b.use_bvh(True)
    b.set_background((0.5, 0.7, 1.0))
    b.set_camera(
        Camera(
            look_from=(13, 2, 3),
            look_at=(0, 0, 0),
            view_up=(0, 1, 0),
            vfov_degrees=20.0,
            focus_dist=10.0,
            defocus_angle_degrees=0.6,
        )
    )
    return b
