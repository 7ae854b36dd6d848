"""The emissive scene (the CLI's default) in the PyTorch port on the CPU,
against the JAX package: a brute scene of three spheres (a 1000-radius
checkered ground, a glass sphere, a sphere light) and a quad light, with
the glass sphere in the light list.

  1. Every compiled table equals the JAX scene's, and the scene takes the
     whole-render kernel (no images).
  2. 16x16, 2 spp, depth 3 against the JAX package's ``Renderer.render``
     (its XLA path on the CPU) within rtol 1e-6 / atol 1e-6 on every
     pixel: no edge-lane exemption is needed (the largest difference seen
     is 2.9e-7, on pixels lit through the glass sphere).
  3. 64x64, 32 spp, depth 10 through the port's goldengate against
     tests/golden/emissive.npz.
"""

import pathlib

import numpy as np
import pytest

import zig_weekend_raytracer_tpu as zj
import zig_weekend_raytracer_tpu_torch as zt
from test_torch_scene import _assert_same
from zig_weekend_raytracer_tpu_torch.ops.bounce import supports_fused_render
from zig_weekend_raytracer_tpu_torch.render import integrator
from zig_weekend_raytracer_tpu_torch.utils.goldengate import check_framebuffer, region_means

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden" / "emissive.npz"


@pytest.fixture(scope="module")
def emissive():
    return zj.models.load_scene("emissive"), zt.models.load_scene("emissive", device="cpu")


def test_emissive_tables_equal_jax(emissive):
    sj, st = emissive
    _assert_same(st.compiled, sj.compiled)
    assert st.camera == zt.scene.Camera(**sj.camera.__dict__)
    cs = st.compiled
    assert (cs.n_spheres, cs.n_quads, len(cs.lights)) == (3, 1, 3)
    assert not (cs.has_sph_tree or cs.has_quad_tree or cs.has_image_textures)
    assert supports_fused_render(cs)


def test_emissive_render_matches_jax(emissive):
    sj, st = emissive
    fb_j = np.asarray(
        zj.render.Renderer(samples_per_pixel=2, max_ray_bounce_depth=3, seed=0).render(sj, 16, 16)
    )
    calls = integrator.render_fused_reference.calls
    fb_t = zt.render.Renderer(samples_per_pixel=2, max_ray_bounce_depth=3, seed=0).render(
        st, 16, 16
    )
    assert integrator.render_fused_reference.calls == calls + 1
    assert fb_t.shape == (16, 16, 3) and np.isfinite(fb_t).all() and fb_t.max() > 0
    np.testing.assert_allclose(fb_t, fb_j, rtol=1e-6, atol=1e-6)


def test_emissive_passes_goldengate(emissive):
    _, st = emissive
    data = np.load(GOLDEN)
    fb = zt.render.Renderer(
        samples_per_pixel=int(data["spp"]), max_ray_bounce_depth=int(data["depth"]),
        seed=int(data["seed"]),
    ).render(st, int(data["width"]), int(data["height"]))
    assert fb.shape == data["fb"].shape and np.isfinite(fb).all()
    verdict = check_framebuffer(fb, float(data["fb"].mean()), region_means(data["fb"], 8))
    assert verdict.startswith("pass"), verdict
