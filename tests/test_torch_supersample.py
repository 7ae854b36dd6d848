"""``Renderer.render_supersampled`` of the PyTorch port on the CPU
(``--supersample=K``), against the JAX package and its tests
(tests/test_supersample.py).

K^2 subpixels of spp / K^2 samples each, box-filtered, keep the plain
render's box pixel filter and budget; under Sobol the K-times grid shifts
by (K - 1) / 2 subpixels so that the subpixels tile each pixel.

  1. Against JAX's ``render_supersampled`` (Pallas interpret) at cornell
     8x8, K = 2, 8 spp, depth 3, and on the half-wall scene at K = 2 and
     4: within rtol 1e-5 / atol 1e-6, on cornell off EDGE_PIXELS: pixel
     (7, 7), whose subpixels' camera rays run exactly along the edge the
     floor shares with the red wall (dx == dy from a camera on x == y,
     witnessed below), where XLA's contracted multiply-adds miss what the
     port's unfused ones hit (test_torch_fused_render settles the side).
  2. An emissive wall filling the view reads its colour exactly, plain
     and supersampled; K = 1 is the plain render bitwise; spp must divide
     by K^2; the half-wall's boundary row reads half coverage in both
     renders (the raster shift); shape and determinism.
"""

import numpy as np
import pytest
import torch

import zig_weekend_raytracer_tpu as zj
import zig_weekend_raytracer_tpu_torch as zt
from zig_weekend_raytracer_tpu import scene as jscene
from zig_weekend_raytracer_tpu_torch.scene import Camera, SceneBuilder

RTOL, ATOL = 1e-5, 1e-6
# (x, y) of cornell 8x8's supersampled pixels (K = 2) with an edge ray
EDGE_PIXELS = ((7, 7),)


@pytest.fixture(scope="module")
def cornell():
    return zt.models.load_scene("cornell_box", device="cpu")


def _wall(mod, rgb=(3.0, 2.0, 1.0), half=False, device=None):
    """An emissive wall filling the view, or (``half``) its top half."""
    b = mod.SceneBuilder()
    light = b.diffuse_light(b.solid_color(rgb))
    b.add(b.quad((-50, 0 if half else -50, -1), (100, 0, 0), (0, 100 if half else 100, 0),
                 light))
    b.set_background((0, 0, 0))
    b.set_camera(mod.Camera(look_from=(0, 0, 5), look_at=(0, 0, 0)))
    return b.compile() if device is None else b.compile(device=device)


def test_supersampled_matches_jax_cornell(pallas_interpret):
    want = np.asarray(zj.render.Renderer(samples_per_pixel=8, max_ray_bounce_depth=3)
                      .render_supersampled(zj.models.load_scene("cornell_box"), 8, 8, k=2))
    got = zt.render.Renderer(samples_per_pixel=8, max_ray_bounce_depth=3).render_supersampled(
        zt.models.load_scene("cornell_box", device="cpu"), 8, 8, k=2).numpy()
    assert got.shape == (8, 8, 3)
    keep = np.ones((8, 8), bool)
    for x, y in EDGE_PIXELS:
        keep[y, x] = False
    np.testing.assert_allclose(got[keep], want[keep], rtol=RTOL, atol=ATOL)


def test_edge_pixel_has_an_edge_ray(cornell):
    """Witness for EDGE_PIXELS: one of the pixel's subpixels (16x16 at the
    raster shift of 0.5) has sample rays with dx == dy from the camera at
    x == y == 278, in the plane through the floor/red-wall edge."""
    import dataclasses

    from zig_weekend_raytracer_tpu_torch.render import camera as tcam

    cam = dataclasses.replace(cornell.camera, raster_shift=(0.5, 0.5))
    params = tcam.camera_params_from_consts(tcam.camera_consts(cam, 16, 16))
    for x, y in EDGE_PIXELS:
        on_edge = 0
        for px, py in ((2 * x + i, 2 * y + j) for i in (0, 1) for j in (0, 1)):
            s = torch.arange(2)
            pxt, pyt = torch.full((2,), px), torch.full((2,), py)
            o, d, _ = tcam.generate_rays(params, False, zt.sampling.SamplerKind.SOBOL, 0,
                                         (s * 16 + pyt) * 16 + pxt, pxt, pyt, s, 2, 16, 16)
            on_edge += int(((d.x == d.y) & (o.x == o.y)).sum())
        assert on_edge >= 2


@pytest.mark.parametrize("k", [2, 4])
def test_supersampled_matches_jax_half_wall(pallas_interpret, k):
    want = np.asarray(zj.render.Renderer(samples_per_pixel=16, max_ray_bounce_depth=2)
                      .render_supersampled(_wall(jscene, (1, 1, 1), half=True), 8, 8, k=k))
    got = zt.render.Renderer(samples_per_pixel=16, max_ray_bounce_depth=2).render_supersampled(
        _wall(zt.scene, (1, 1, 1), half=True, device="cpu"), 8, 8, k=k).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_emissive_wall_exact():
    scene = _wall(zt.scene, device="cpu")
    r = zt.render.Renderer(samples_per_pixel=4, max_ray_bounce_depth=3, seed=0)
    plain = r.render_device(scene, 10, 10).numpy()
    ss = r.render_supersampled(scene, 10, 10, k=2).numpy()
    np.testing.assert_allclose(plain, np.array([3.0, 2.0, 1.0]) * np.ones((10, 10, 3)),
                               atol=1e-6)
    np.testing.assert_allclose(ss, plain, atol=1e-6)


def test_k1_is_plain_render(cornell):
    r = zt.render.Renderer(samples_per_pixel=4, max_ray_bounce_depth=3, seed=5)
    np.testing.assert_array_equal(r.render_supersampled(cornell, 12, 12, k=1).numpy(),
                                  r.render_device(cornell, 12, 12).numpy())


def test_spp_must_divide(cornell):
    r = zt.render.Renderer(samples_per_pixel=6, max_ray_bounce_depth=3)
    with pytest.raises(ValueError, match="divisible"):
        r.render_supersampled(cornell, 8, 8, k=2)
    with pytest.raises(ValueError, match=">= 1"):
        r.render_supersampled(cornell, 8, 8, k=0)


def test_sobol_raster_alignment():
    scene = _wall(zt.scene, (1.0, 1.0, 1.0), half=True, device="cpu")
    r = zt.render.Renderer(samples_per_pixel=64, max_ray_bounce_depth=2, seed=0)
    plain = r.render_device(scene, 8, 8).numpy().mean((1, 2))
    ss = r.render_supersampled(scene, 8, 8, k=2).numpy().mean((1, 2))
    np.testing.assert_allclose(plain[:3], 1.0, atol=1e-6)
    np.testing.assert_allclose(plain[4:], 0.0, atol=1e-6)
    assert abs(plain[3] - 0.5) < 0.05, plain
    assert abs(ss[3] - 0.5) < 0.05, ss
    np.testing.assert_allclose(ss[:3], 1.0, atol=1e-6)
    np.testing.assert_allclose(ss[4:], 0.0, atol=1e-6)
    # the caller's camera is left as it was
    assert scene.camera.raster_shift == (0.0, 0.0)


def test_shape_and_determinism(cornell):
    r = zt.render.Renderer(samples_per_pixel=8, max_ray_bounce_depth=3, seed=2)
    fb1 = r.render_supersampled(cornell, 12, 10, k=2).numpy()
    fb2 = r.render_supersampled(cornell, 12, 10, k=2).numpy()
    assert fb1.shape == (10, 12, 3) and not np.isnan(fb1).any()
    np.testing.assert_array_equal(fb1, fb2)
