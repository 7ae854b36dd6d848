"""The AOV-guided à-trous denoiser of the port (``render/denoise.py``) on
the CPU, against the JAX package's ``render/denoise.py``.

  1. ``_shift2d`` equal to JAX's for shifts inside and past the image.
  2. ``estimate_noise_sigma`` equal to JAX's (the same numpy code) on
     seeded colour and AOVs, with misses, edges and partial coverage.
  3. ``denoise`` at 0, 1 and 3 iterations with ``sigma_l="auto"`` and at a
     fixed sigma_l, on the same seeded inputs, within rtol 1e-5 / atol 1e-6
     of JAX's jitted filter (exp and pow round differently in XLA and
     torch by an ulp or two; x^64 in the normal stop scales that 64-fold).
  4. The properties of the JAX package's tests/test_denoise.py: the
     identity at 0 iterations, an image of constant irradiance is a fixed
     point, the cornell light survives the albedo stop, and texture detail
     survives the demodulation on earth.
"""

import numpy as np
import pytest
import torch

import zig_weekend_raytracer_tpu_torch as zt
from test_torch_reference_native import reference_decodes_with_stb  # noqa: F401
from zig_weekend_raytracer_tpu.render import denoise as jd
from zig_weekend_raytracer_tpu_torch.render import denoise as td
from zig_weekend_raytracer_tpu_torch.render.aov import render_aovs

RTOL, ATOL = 1e-5, 1e-6


def _inputs(seed=0, h=24, w=20):
    """Seeded colour and AOVs: a flat albedo band, shortened normals
    (partial coverage), a block of misses (zero normal and depth)."""
    rng = np.random.default_rng(seed)
    alb = rng.uniform(0.05, 0.9, (h, w, 3)).astype(np.float32)
    alb[:, :4] = 0.7
    n = rng.normal(size=(h, w, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    n[:3] *= 0.6
    n[-2:, -3:] = 0.0
    depth = rng.uniform(1.0, 10.0, (h, w)).astype(np.float32)
    depth[-2:, -3:] = 0.0
    color = (alb * rng.uniform(0.1, 2.0, (h, w, 3))).astype(np.float32)
    return color, {"albedo": alb, "normal": n, "depth": depth}


@pytest.mark.parametrize("dy,dx", [(0, 0), (1, -2), (-3, 4), (8, 0), (0, -30), (-40, 25)])
def test_shift2d_matches_jax(dy, dx):
    x = np.random.default_rng(1).normal(size=(7, 9, 3)).astype(np.float32)
    want = np.asarray(jd._shift2d(x, dy, dx))
    np.testing.assert_array_equal(td._shift2d(torch.from_numpy(x), dy, dx).numpy(), want)


@pytest.mark.parametrize("seed", [0, 1])
def test_noise_sigma_matches_jax(seed):
    color, aovs = _inputs(seed)
    got = td.estimate_noise_sigma(torch.from_numpy(color), {k: torch.from_numpy(v)
                                                            for k, v in aovs.items()})
    assert got == jd.estimate_noise_sigma(color, aovs) > 0


@pytest.mark.parametrize("iterations,sigma_l", [(0, "auto"), (1, "auto"), (3, "auto"),
                                                (3, 0.5), (2, 2.0)])
def test_denoise_matches_jax(iterations, sigma_l):
    color, aovs = _inputs()
    want = np.asarray(jd.denoise(color, aovs, iterations=iterations, sigma_l=sigma_l))
    got = td.denoise(torch.from_numpy(color), aovs, iterations=iterations, sigma_l=sigma_l)
    assert got.dtype == torch.float32 and got.shape == (24, 20, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    if iterations:
        assert np.abs(want - color).max() > 1e-2  # the filter did something


def _cornell(spp, seed):
    scene = zt.models.load_scene("cornell_box", device="cpu")
    r = zt.render.Renderer(samples_per_pixel=spp, max_ray_bounce_depth=5, seed=seed)
    return scene, r.render(scene, 32, 32)


def test_identity_at_zero_iterations():
    scene, noisy = _cornell(2, 0)
    aovs = render_aovs(scene, 32, 32, spp=1)
    np.testing.assert_array_equal(td.denoise(noisy, aovs, iterations=0).numpy(), noisy)


def test_constant_irradiance_is_fixed_point():
    scene = zt.models.load_scene("cornell_box", device="cpu")
    aovs = render_aovs(scene, 16, 16, spp=1)
    color = 0.5 * torch.clamp(aovs["albedo"], min=1e-4)
    out = td.denoise(color, aovs, iterations=3)
    np.testing.assert_allclose(out.numpy(), color.numpy(), rtol=3e-3, atol=1e-4)


def test_emitter_preserved_by_albedo_stop():
    scene, noisy = _cornell(8, 0)
    dn = td.denoise(noisy, render_aovs(scene, 32, 32, spp=4)).numpy()
    assert np.isfinite(dn).all() and (dn >= 0).all()
    assert dn.max() > 0.85 * noisy.max()


def test_texture_detail_survives_demodulation():
    """The filter smooths lighting, not texture: the denoised earth stays
    closer to the AOV albedo's structure than a 5x5 box blur does."""
    scene = zt.models.load_scene("earth", device="cpu")
    noisy = zt.render.Renderer(samples_per_pixel=4, max_ray_bounce_depth=4, seed=0).render(
        scene, 32, 32)
    aovs = render_aovs(scene, 32, 32, spp=2)
    dn = td.denoise(noisy, aovs).numpy()
    assert np.isfinite(dn).all() and (dn >= 0).all()
    alb = aovs["albedo"].numpy()

    def corr(img):
        a = img.reshape(-1, 3).mean(1) - img.mean()
        b = alb.reshape(-1, 3).mean(1) - alb.mean()
        return float((a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum()))

    blur = np.stack([
        sum(np.roll(np.roll(noisy[..., c], dy, 0), dx, 1)
            for dy in range(-2, 3) for dx in range(-2, 3)) / 25.0
        for c in range(3)
    ], -1)
    assert corr(dn) > corr(blur)
