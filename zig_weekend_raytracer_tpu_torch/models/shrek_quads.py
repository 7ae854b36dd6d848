"""Five image-textured quads (counterpart of ``models/shrek_quads.py``,
constant for constant)."""

from __future__ import annotations

import os

from ..io.image import load_image
from ..scene import Camera, Scene, SceneBuilder


def load_scene_shrek_quads(seed: int = 0, asset_dir: str = "", device="cuda",
                           texture_lut=None) -> Scene:
    b = SceneBuilder()
    tex = b.image_texture(load_image(os.path.join(asset_dir, "wap.jpg")))
    # one material per quad, as the reference has
    m_left, m_back, m_right, m_top, m_bottom = [b.lambertian(tex) for _ in range(5)]

    b.add(b.quad((-3, -2, 5), (0, 0, -4), (0, 4, 0), m_left))
    b.add(b.quad((-2, -2, 0), (4, 0, 0), (0, 4, 0), m_right))
    b.add(b.quad((3, -2, 1), (0, 0, 4), (0, 4, 0), m_back))
    b.add(b.quad((-2, 3, 1), (4, 0, 0), (0, 0, 4), m_top))
    b.add(b.quad((-2, -3, 5), (4, 0, 0), (0, 0, -4), m_bottom))

    b.set_background((0.5, 0.7, 1.0))
    b.set_camera(
        Camera(
            look_from=(0, 0, 9),
            look_at=(0, 0, 0),
            view_up=(0, 1, 0),
            vfov_degrees=80.0,
            focus_dist=10.0,
            defocus_angle_degrees=0.0,
        )
    )
    return b.compile(name="shrek_quads", device=device, texture_lut=texture_lut)
