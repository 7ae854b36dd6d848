"""Emissive default scene: quad and sphere area lights, a glass sphere in
the light list, a checkered ground (counterpart of ``models/emissive.py``,
constant for constant; reference: loadSceneEmissive,
src/scene.zig:232-310)."""

from __future__ import annotations

from ..scene import Camera, Scene, SceneBuilder


def load_scene_emissive(seed: int = 0, asset_dir: str = "", device="cuda",
                        texture_lut=None) -> Scene:
    b = SceneBuilder()

    tex_even = b.solid_color((0.2, 0.3, 0.1))
    tex_odd = b.solid_color((0.9, 0.9, 0.9))
    tex_ground = b.checkerboard(0.32, tex_even, tex_odd)
    tex_light_blue = b.solid_color((1, 2, 4))
    tex_light_green = b.solid_color((2.3, 4, 2.3))

    m_glass = b.dielectric(1.5)
    m_ground = b.lambertian(tex_ground)
    m_light_blue = b.diffuse_light(tex_light_blue)
    m_light_green = b.diffuse_light(tex_light_green)

    b.add(b.sphere((0, -1000, 0), 1000, m_ground))
    glass_sphere = b.add(b.sphere((0, 2, 0), 1.5, m_glass))
    light_quad = b.add(b.quad((3, 1, -2), (2, 0, 0), (0, 2, 0), m_light_blue))
    light_sphere = b.add(b.sphere((0, 7, 0), 1, m_light_green))

    b.use_bvh(True)
    # the glass sphere is importance-sampled too (src/scene.zig:288-291)
    b.set_lights([light_quad, light_sphere, glass_sphere])
    b.set_background((0, 0, 0))
    b.set_camera(
        Camera(
            look_from=(26, 3, 6),
            look_at=(0, 2, 0),
            view_up=(0, 1, 0),
            vfov_degrees=20.0,
            focus_dist=10.0,
            defocus_angle_degrees=0.0,
        )
    )
    return b.compile(name="emissive", device=device, texture_lut=texture_lut)
