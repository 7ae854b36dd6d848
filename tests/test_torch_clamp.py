"""The indirect luminance clamp in the PyTorch port on the CPU
(``Renderer(clamp_indirect=c)``, ``--clamp_indirect``), against the JAX
package.

A radiance contribution landed at bounce d >= 1 (the background at a miss,
emission at a hit) is scaled so that its luminance is at most c; direct
light stays exact.  The port's plain versions follow the JAX kernels and
their gate (``pallas_bounce.py:_base_cfg``): off on an image scene without
a texture LUT, on with one.

  1. The whole-render kernel's plain version against JAX's ``render_fused``
     (Pallas interpret) at cornell 16x16, 2 spp, depth 3: work counts
     bitwise, radiance within rtol 1e-6 / atol 1e-7 off the EDGE_LANES of
     test_torch_fused_render (its witness test settles them).
  2. One bounce against JAX's ``bounce_pallas`` on seeded cornell rays:
     alive bitwise and radiance within rtol 1e-6 / atol 1e-7 at bounce 1;
     at bounce 0 the clamp changes nothing, bitwise.
  3. The clamp only removes energy, and the brightest pixel (the light seen
     directly) keeps its value; direct light under a tiny clamp reads the
     full emission (JAX's test_clamp.py).
  4. The gate: ignored on an atlas image scene, bitwise; applied with a
     texture LUT, where the plain render equals JAX's kernel.

The CUDA kernels' estimator instantiations are held against these plain
versions on the card by chip_smoke.py (phase 23).
"""

import os

import numpy as np
import pytest

import zig_weekend_raytracer_tpu as zj
import zig_weekend_raytracer_tpu_torch as zt
from test_torch_fused_render import EDGE_LANES
from test_torch_reference_native import reference_decodes_with_stb  # noqa: F401
from test_torch_russian_roulette import RTOL, ATOL, cornell_rays, one_bounce_pair, render_pair
from zig_weekend_raytracer_tpu_torch.render import integrator
from zig_weekend_raytracer_tpu_torch.scene import Camera, SceneBuilder

CLAMP = 0.25


@pytest.fixture(scope="module")
def cornell():
    return zj.models.load_scene("cornell_box"), zt.models.load_scene("cornell_box", device="cpu")


def test_clamp_render_matches_jax_kernel(pallas_interpret, cornell):
    rt, work = render_pair(*cornell, 16, 16, 2, 3, EDGE_LANES, clamp=CLAMP)
    rt0, work0 = render_pair(*cornell, 16, 16, 2, 3, EDGE_LANES)
    # the clamp moves radiance, never a path
    np.testing.assert_array_equal(work, work0)
    assert (rt <= rt0 + 1e-6).all() and rt.sum() < rt0.sum()


def test_clamp_one_bounce_matches_jax_kernel(pallas_interpret, cornell):
    r = cornell_rays(seed=4)
    r["throughput"] *= 40.0  # bright paths, so that emission passes the clamp
    (got, alive_t), (want, alive_j) = one_bounce_pair(*cornell, r, 1, clamp=CLAMP)
    np.testing.assert_array_equal(alive_t, alive_j)
    np.testing.assert_allclose(got[9:], want[9:], rtol=RTOL, atol=ATOL)
    (got0, alive0), _ = one_bounce_pair(*cornell, r, 1)
    np.testing.assert_array_equal(alive_t, alive0)
    clamped = (got[9:] != got0[9:]).any(0)
    assert clamped.sum() > 5 and (got[9:] <= got0[9:]).all()
    # at bounce 0 every contribution is direct
    (g0, a0), _ = one_bounce_pair(*cornell, r, 0, clamp=CLAMP)
    (h0, b0), _ = one_bounce_pair(*cornell, r, 0)
    np.testing.assert_array_equal(g0, h0)
    np.testing.assert_array_equal(a0, b0)


def test_clamp_caps_indirect_and_keeps_the_brightest_pixel(cornell):
    _, st = cornell
    base = zt.render.Renderer(samples_per_pixel=8, max_ray_bounce_depth=8, seed=0)
    cl = zt.render.Renderer(samples_per_pixel=8, max_ray_bounce_depth=8, seed=0,
                            clamp_indirect=CLAMP)
    fb0 = base.render(st, 16, 16)
    fb1 = cl.render(st, 16, 16)
    assert (fb1 <= fb0 + 1e-6).all()
    assert fb1.sum() < fb0.sum()
    assert fb1.max() == fb0.max()


def test_clamp_preserves_direct_light():
    b = SceneBuilder()
    light = b.diffuse_light(b.solid_color((15, 14, 13)))
    b.add(b.quad((-50, -50, -1), (100, 0, 0), (0, 100, 0), light))
    b.set_background((0, 0, 0))
    b.set_camera(Camera(look_from=(0, 0, 5), look_at=(0, 0, 0)))
    scene = b.compile(device="cpu")
    fb = zt.render.Renderer(samples_per_pixel=2, max_ray_bounce_depth=4,
                            clamp_indirect=0.05).render(scene, 8, 8)
    np.testing.assert_allclose(fb[..., 0], 15.0, rtol=1e-5)


def test_clamp_ignored_on_atlas_image_scenes():
    st = zt.models.load_scene("shrek_quads", device="cpu")
    base = zt.render.Renderer(samples_per_pixel=2, max_ray_bounce_depth=4, seed=0)
    cl = zt.render.Renderer(samples_per_pixel=2, max_ray_bounce_depth=4, seed=0,
                            clamp_indirect=0.1)
    np.testing.assert_array_equal(base.render(st, 12, 12), cl.render(st, 12, 12))


def test_clamp_applied_with_a_texture_lut(pallas_interpret):
    budget = 1 << 22
    os.environ["ZWRT_TEX_LUT"] = str(budget)
    try:
        sj = zj.models.load_scene("shrek_quads")
    finally:
        del os.environ["ZWRT_TEX_LUT"]
    st = zt.models.load_scene("shrek_quads", device="cpu", texture_lut=budget)
    assert integrator.estimator_options(st.compiled, 0, 0.1) == (0, np.float32(0.1))
    rt, _ = render_pair(sj, st, 12, 12, 2, 3, clamp=0.1)
    rt0, _ = render_pair(sj, st, 12, 12, 2, 3)
    assert (rt <= rt0 + 1e-6).all() and rt.sum() < rt0.sum()
