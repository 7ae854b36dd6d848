"""Book-2 final scene: ground boxes, an area light, glass, fuzzy metal,
two image-textured spheres and an instanced 1000-sphere cluster
(counterpart of ``models/rtw_final.py``, constant for constant and draw
for draw)."""

from __future__ import annotations

import os

import numpy as np

from ..io.image import load_image
from ..scene import Camera, Scene, SceneBuilder


def load_scene_rtw_final(seed: int = 0, asset_dir: str = "", device="cuda",
                         texture_lut=None) -> Scene:
    rand = np.random.default_rng(seed)
    b = SceneBuilder()

    # ground boxes
    m_ground = b.lambertian(b.solid_color((0.4, 0.83, 0.53)))
    n_per_side = 20
    w = 100.0
    for i in range(n_per_side):
        for j in range(n_per_side):
            x0 = -1000.0 + i * w
            z0 = -1000.0 + j * w
            y1 = rand.random() * 100.0 + 1.0
            b.add(b.box((x0, 0.0, z0), (x0 + w, y1, z0 + w), m_ground))

    # light
    m_light = b.diffuse_light(b.solid_color((7, 7, 7)))
    light = b.add(b.quad((123, 554, 147), (300, 0, 0), (0, 0, 265), m_light))

    # feature spheres
    b.add(b.sphere((260, 150, 45), 50.0, b.dielectric(1.5)))
    b.add(b.sphere((0, 150, 145), 50, b.metal((0.8, 0.8, 0.9), 1.0)))
    b.add(b.sphere((360, 150, 145), 70, b.dielectric(1.5)))

    tex_shrek = b.image_texture(load_image(os.path.join(asset_dir, "wap.jpg")))
    b.add(b.sphere((400, 200, 400), 100, b.lambertian(tex_shrek)))
    tex_me = b.image_texture(load_image(os.path.join(asset_dir, "me.jpg")))
    b.add(b.sphere((220, 280, 300), 80, b.lambertian(tex_me)))

    # instanced 1000-sphere cluster
    m_white = b.lambertian(b.solid_color((0.73, 0.73, 0.73)))
    cluster = b.collection(
        [b.sphere(rand.random(3) * 165.0, 10, m_white) for _ in range(1000)],
        bvh=True,
    )
    b.add(b.translate((-100, 270, 395), b.rotate_y(15.0, cluster)))

    b.use_bvh(True)
    b.set_lights([light])
    b.set_background((0, 0, 0))
    b.set_camera(
        Camera(
            look_from=(478, 278, -600),
            look_at=(278, 278, 0),
            view_up=(0, 1, 0),
            vfov_degrees=40.0,
            focus_dist=10.0,
            defocus_angle_degrees=0.0,
        )
    )
    return b.compile(name="rtw_final", device=device, texture_lut=texture_lut)
