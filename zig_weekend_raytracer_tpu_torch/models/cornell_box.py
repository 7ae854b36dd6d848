"""Cornell box with glass sphere and rotated metal box (counterpart of
``models/cornell_box.py``, constant for constant)."""

from __future__ import annotations

from ..scene import Camera, Scene, SceneBuilder


def load_scene_cornell_box(seed: int = 0, asset_dir: str = "", device="cuda",
                           texture_lut=None) -> Scene:
    b = SceneBuilder()

    tex_red = b.solid_color((0.65, 0.05, 0.05))
    tex_white = b.solid_color((0.73, 0.73, 0.73))
    tex_green = b.solid_color((0.12, 0.45, 0.15))
    tex_light = b.solid_color((15, 15, 15))

    m_red = b.lambertian(tex_red)
    m_white = b.lambertian(tex_white)
    m_green = b.lambertian(tex_green)
    m_light = b.diffuse_light(tex_light)
    m_glass = b.dielectric(1.5)
    m_metal = b.metal((0.8, 0.85, 0.88), 0)

    # walls
    b.add(b.quad((555, 0, 0), (0, 555, 0), (0, 0, 555), m_green))
    b.add(b.quad((0, 0, 0), (0, 555, 0), (0, 0, 555), m_red))
    b.add(b.quad((0, 0, 0), (555, 0, 0), (0, 0, 555), m_white))
    b.add(b.quad((555, 555, 555), (-555, 0, 0), (0, 0, -555), m_white))
    b.add(b.quad((0, 0, 555), (555, 0, 0), (0, 555, 0), m_white))

    glass_sphere = b.add(b.sphere((190, 90, 190), 90, m_glass))
    b.add(
        b.translate(
            (265, 0, 295),
            b.rotate_y(15.0, b.box((0, 0, 0), (165, 330, 165), m_metal)),
        )
    )
    light = b.add(b.quad((343, 554, 332), (-150, 0, 0), (0, 0, -125), m_light))

    b.use_bvh(True)
    b.set_lights([glass_sphere, light])
    b.set_background((0, 0, 0))
    b.set_camera(
        Camera(
            look_from=(278, 278, -800),
            look_at=(278, 278, 0),
            view_up=(0, 1, 0),
            vfov_degrees=40.0,
            focus_dist=10.0,
            defocus_angle_degrees=0.0,
        )
    )
    return b.compile(name="cornell_box", device=device, texture_lut=texture_lut)
