"""The two-pass balanced driver and the driver opt-outs of the PyTorch port
on the CPU (``Renderer(balance_min_spp=N)``, ``ZWRT_NO_BALANCE``,
``ZWRT_NO_SORT``, ``ZWRT_COHERENT=0``), against the JAX package.

  1. ``build_balance_plan`` lane for lane equal to JAX's on seeded cost
     maps, flat and tiled, with the lane budget of ``balance_lane_budget``
     at JAX's block (rows * 128) equal to JAX's; every (pixel, sample) of
     [spp_est, spp) owned by one lane.
  2. The balanced render against JAX's ``Renderer(balance_min_spp=...)``
     (Pallas interpret) at cornell 16x16, 16 spp, depth 3 with the
     independent sampler (whose jitter keeps off test_torch_fused_render's
     edge rays), within rtol 1e-5 / atol 1e-6; against the port's sorted
     render within the same tolerance, on a brute and an atlas image scene.
  3. spp = 1 is not overbright (the estimation pass is the render).
  4. Each opt-out is honoured: the driver it names does not run (without
     balancing the sorted plan renders, without sorting or coherence the
     plain lane layout), and the image is the default render's, bitwise.
"""

import numpy as np
import pytest

from test_torch_reference_native import reference_decodes_with_stb  # noqa: F401
import zig_weekend_raytracer_tpu as zj
import zig_weekend_raytracer_tpu_torch as zt
from zig_weekend_raytracer_tpu.render import renderer as jr
from zig_weekend_raytracer_tpu.sampling.sampler import SamplerKind as JKind
from zig_weekend_raytracer_tpu_torch.render import renderer as tr
from zig_weekend_raytracer_tpu_torch.render import integrator

RTOL, ATOL = 1e-5, 1e-6


@pytest.mark.parametrize("tile", [None, 32])
@pytest.mark.parametrize("seed", [0, 1])
def test_balance_plan_equals_jax(tile, seed):
    rng = np.random.default_rng(seed)
    rows, width, spp_est, spp = 40, 70, 4, 64
    work = rng.integers(1, 50, (rows, width))
    blk = 8 * 128  # JAX's wavefront block at rows 8
    budget = tr.balance_lane_budget(rows, width, 1.3, blk)
    assert budget == -(-int(1.3 * rows * width) // blk) * blk
    got = tr.build_balance_plan(work, 3, spp_est, spp, budget, tile)
    want = jr.build_balance_plan(work, 3, spp_est, spp, budget, tile)
    for a, b in zip(got, want):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    counts = np.zeros((rows, width, spp), np.int32)
    for x, y, a, b in zip(*got):
        counts[y - 3, x, a:b] += 1
    assert (counts[:, :, spp_est:] == 1).all() and not counts[:, :, :spp_est].any()
    # the port's default block is the render kernel's
    assert tr.balance_lane_budget(rows, width, 1.3) % 128 == 0


def test_balanced_render_matches_jax(pallas_interpret):
    # regen_min_wave=1: one sample in flight per pixel (s_par = 1), the
    # balanced driver's gate, at this size
    opts = dict(samples_per_pixel=16, max_ray_bounce_depth=3, balance_min_spp=16,
                regen_min_wave=1)
    want = zj.render.Renderer(sampler=JKind.INDEPENDENT, **opts).render(
        zj.models.load_scene("cornell_box"), 16, 16)
    r = zt.render.Renderer(sampler=zt.sampling.SamplerKind.INDEPENDENT, **opts)
    calls = integrator.render_fused_reference.calls
    got = r.render(zt.models.load_scene("cornell_box", device="cpu"), 16, 16)
    # the estimation pass and the balanced plan: two launches' worth
    assert integrator.render_fused_reference.calls == calls + 2
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["cornell_box", "shrek_quads"])
def test_balanced_render_matches_sorted_render(name):
    scene = zt.models.load_scene(name, device="cpu")
    opts = dict(samples_per_pixel=32, max_ray_bounce_depth=4, regen_min_wave=1)
    r = zt.render.Renderer(balance_min_spp=32, **opts)
    calls = integrator.render_fused_reference.calls
    passes = integrator.trace_paths_regen.bands
    bal = r.render(scene, 24, 24)
    # the estimation pass and the balanced plan
    assert (integrator.render_fused_reference.calls - calls
            + integrator.trace_paths_regen.bands - passes) == 2
    plain = zt.render.Renderer(**opts).render(scene, 24, 24)
    assert np.isfinite(bal).all()
    np.testing.assert_allclose(bal, plain, rtol=RTOL, atol=ATOL)


def test_balanced_driver_spp1_not_overbright():
    scene = zt.models.load_scene("cornell_box", device="cpu")
    plain = zt.render.Renderer(samples_per_pixel=1, max_ray_bounce_depth=3).render(scene, 16, 16)
    bal = zt.render.Renderer(samples_per_pixel=1, max_ray_bounce_depth=3, balance_min_spp=1,
                             regen_min_wave=1).render(scene, 16, 16)
    np.testing.assert_allclose(bal, plain, rtol=1e-6, atol=1e-7)


def _refuse(monkeypatch, name):
    def boom(*a, **k):
        raise AssertionError(f"{name} ran")

    monkeypatch.setattr(tr.Renderer, name, boom)


@pytest.mark.parametrize("env,scene_name,driver", [
    ("ZWRT_NO_BALANCE", "cornell_box", "_render_band_balanced_driver"),
    ("ZWRT_NO_SORT", "cornell_box", "_render_band_sorted_driver"),
    ("ZWRT_COHERENT", "balls", "_render_band_coherent_driver"),
])
def test_opt_outs_are_honoured(env, scene_name, driver, monkeypatch):
    scene = zt.models.load_scene(scene_name, device="cpu")
    opts = dict(samples_per_pixel=4, max_ray_bounce_depth=3, regen_min_wave=1)
    want = zt.render.Renderer(**opts).render(scene, 16, 16)
    if env == "ZWRT_NO_BALANCE":
        opts["balance_min_spp"] = 4
    monkeypatch.setenv(env, "0" if env == "ZWRT_COHERENT" else "1")
    _refuse(monkeypatch, driver)
    r = zt.render.Renderer(**opts)
    got = r.render(scene, 16, 16)
    got2 = r.render(scene, 16, 16)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got2, want)
    # without balancing the sorted plan renders; the other two leave the
    # plain lane layout, which keeps no plan
    plans = r._plan_cache.get(scene.compiled) or {}
    assert bool(plans) == (env == "ZWRT_NO_BALANCE")
