"""The render and bounce kernels' light list and image dims as device tables
of any length (``ops/fused_render.py``: ``light_table``, ``launch_tables``,
``image_args``), where the kernels once took at most 8 lights and 16
images.

  1. A scene of 9 lights (spheres and quads): the table holds every light's
     kind and parameters in the light list's order, the launch packs it
     without a cap, and the plain version renders it to finite radiance
     that the lights light.
  2. A scene of 17 image-textured quads: the dims table holds each image's
     (width, height, base, row stride) as the plain fetch reads them, from
     the atlas and from a texture LUT.
"""

import numpy as np
import pytest
import torch

import zig_weekend_raytracer_tpu_torch as zt
from zig_weekend_raytracer_tpu_torch.ops import fused_render
from zig_weekend_raytracer_tpu_torch.render import camera as tcam
from zig_weekend_raytracer_tpu_torch.textures import image_table


def nine_light_scene():
    """A gray floor under 9 lights: 5 quads and 4 spheres."""
    b = zt.scene.SceneBuilder()
    gray = b.lambertian(b.solid_color((0.6, 0.6, 0.6)))
    b.add(b.quad((-6, 0, -6), (12, 0, 0), (0, 0, 12), gray))
    lights = []
    for k in range(9):
        lamp = b.diffuse_light(b.solid_color((1.0 + k, 2.0, 3.0)))
        x = -4.0 + k
        if k % 2 == 0:
            lights.append(b.add(b.quad((x, 3.0, -0.5), (0.8, 0, 0), (0, 0, 0.8), lamp)))
        else:
            lights.append(b.add(b.sphere((x, 2.5, 0.5), 0.3, lamp)))
    b.set_lights(lights)
    b.set_background((0.0, 0.0, 0.0))
    b.set_camera(zt.scene.Camera(look_from=(0, 4, 9), look_at=(0, 1, 0)))
    return b.compile(device="cpu")


def seventeen_image_scene(texture_lut=0):
    """17 quads, each textured with its own image of its own size."""
    b = zt.scene.SceneBuilder()
    rng = np.random.default_rng(17)
    for k in range(17):
        img = rng.integers(0, 256, (3 + k, 5 + (k % 4), 3), dtype=np.uint8)
        mat = b.lambertian(b.image_texture(img))
        b.add(b.quad((-8.5 + k, 0, 0), (0.9, 0, 0), (0, 0.9, 0), mat))
    b.set_camera(zt.scene.Camera(look_from=(0, 0.5, 12), look_at=(0, 0.5, 0)))
    return b.compile(device="cpu", texture_lut=texture_lut)


def test_nine_lights_pack_and_render():
    sc = nine_light_scene()
    cs = sc.compiled
    assert len(cs.light_params) == 9
    kinds, rows = fused_render.light_table(cs)
    assert kinds.dtype == torch.int32 and rows.shape == (9, fused_render.LIGHT_FLOATS)
    assert kinds.tolist() == [k for k, _ in cs.light_params] and set(kinds.tolist()) == {0, 1}
    for row, (_, p) in zip(rows.numpy(), cs.light_params):
        np.testing.assert_array_equal(row[: len(p)], np.asarray(p, np.float32))
        assert not row[len(p):].any()
    assert fused_render.light_table(cs) is fused_render.light_table(cs)
    cam = tcam.camera_consts(sc.camera, 8, 8)
    ints, _ = fused_render.launch_params(cs, 0, zt.dtypes.T_MIN, cam,
                                         zt.sampling.SamplerKind.SOBOL, 8, 8, 4, 1, 5, False)
    assert ints[12] == 9  # n_lights
    ptrs, keep = fused_render.launch_tables(cs, zt.sampling.SamplerKind.SOBOL, 8, 8, 4)
    assert list(ptrs[:2]) == [kinds.data_ptr(), rows.data_ptr()]
    w, spp = 8, 4
    ys, xs = torch.meshgrid(torch.arange(w), torch.arange(w), indexing="ij")
    px, py = xs.reshape(-1).to(torch.int32), ys.reshape(-1).to(torch.int32)
    s0 = torch.zeros_like(px)
    rad = fused_render.render_fused(
        cs, px, py, s0, s0 + spp, 0, zt.dtypes.T_MIN, camera_consts=cam,
        sampler=zt.sampling.SamplerKind.SOBOL, width=w, height=w, spp=spp, stride=1,
        max_depth=5, has_dof=False)
    arr = rad.to_array().numpy()
    assert np.isfinite(arr).all() and arr.sum() > 0


@pytest.mark.parametrize("budget", [0, 4096])
def test_seventeen_images_pack(budget):
    cs = seventeen_image_scene(budget).compiled
    assert cs.has_image_textures and len(cs.image_dims) == 17
    assert bool(cs.tex_lut_dims) == bool(budget)
    dims, texels = fused_render.image_args(cs)
    want_dims, want_texels = image_table(cs)
    assert dims.dtype == torch.int32 and dims.shape == (17, fused_render.IMAGE_DIMS)
    assert dims.tolist() == [list(d) for d in want_dims]
    assert torch.equal(texels, want_texels)
    # every image is its own: sizes differ, bases increase
    assert len({tuple(d[:2]) for d in dims.tolist()}) > 4
    assert (dims[1:, 2] > dims[:-1, 2]).all()
