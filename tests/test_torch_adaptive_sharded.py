"""Sharded adaptive sampling in the PyTorch port on the CPU
(``parallel/render.py:render_adaptive_sharded``), against the JAX package's
and its tests (tests/test_adaptive_sharded.py).

  1. Against JAX's ``render_adaptive_sharded`` (Pallas interpret: without
     a kernel backend JAX falls back to the uniform render) at cornell
     16x16, 16 spp, pilot 4, depth 3, n = 2, both modes, with the
     independent sampler (its jitter keeps off test_torch_fused_render's
     edge rays): the sample-count map equal, and the framebuffer within
     test_torch_adaptive.py's tolerance (rtol 1e-5 / atol 1e-6 on all but
     2% of pixels, means within 1e-3).
  2. Against the port's ``render_adaptive``: a one-device mesh bitwise in
     both modes; in samples mode the count map equal at every n (the pilot
     splits the band's rows, so each pixel's pilot sums are the
     single-device ones) and the framebuffer within rtol 1e-5 / atol 1e-6
     (the extra pass's regrouped sums), in one band and in bands of 8 rows.
  3. Rows mode: the budget conserved per device region and in total, a
     height (13) that 8 devices do not divide; the stratified sampler and an
     unknown mode raise; a pilot that covers spp renders uniformly.
"""

import numpy as np
import pytest

import zig_weekend_raytracer_tpu as zj
import zig_weekend_raytracer_tpu_torch as zt
from zig_weekend_raytracer_tpu.parallel import make_mesh as jmesh
from zig_weekend_raytracer_tpu.parallel import render_adaptive_sharded as jadaptive
from zig_weekend_raytracer_tpu.sampling.sampler import SamplerKind as JKind
from zig_weekend_raytracer_tpu_torch.parallel import (
    make_mesh,
    render_adaptive_sharded,
    render_sharded,
)
from zig_weekend_raytracer_tpu_torch.sampling.sampler import SamplerKind

RTOL, ATOL = 1e-5, 1e-6
SPP, PILOT, DEPTH = 16, 4, 3


@pytest.fixture(scope="module")
def cornell():
    return zt.models.load_scene("cornell_box", device="cpu")


def _port(scene, n, shard, h=16, **kw):
    return render_adaptive_sharded(scene, 16, h, SPP, max_depth=DEPTH,
                                   mesh=make_mesh(n, device="cpu"), shard=shard, seed=0,
                                   pilot_spp=PILOT, return_stats=True, **kw)


def _single(scene, h=16, **kw):
    r = zt.render.Renderer(samples_per_pixel=SPP, max_ray_bounce_depth=DEPTH, seed=0, **kw)
    return r.render_adaptive(scene, 16, h, pilot_spp=PILOT, return_stats=True)


# ---- 1. against the JAX package ----

@pytest.mark.parametrize("shard", ["samples", "rows"])
def test_adaptive_sharded_matches_jax(pallas_interpret, cornell, shard):
    fb_j, st_j = jadaptive(zj.models.load_scene("cornell_box"), 16, 16, SPP, max_depth=DEPTH,
                           sampler=JKind.INDEPENDENT, mesh=jmesh(2), shard=shard, seed=0,
                           pilot_spp=PILOT, return_stats=True)
    fb_t, st_t = _port(cornell, 2, shard, sampler=SamplerKind.INDEPENDENT)
    assert st_t["pilot"] == st_j["pilot"] == PILOT
    np.testing.assert_array_equal(st_t["n_samples"], st_j["n_samples"])
    assert st_t["n_samples"].sum() == SPP * 16 * 16
    got, want = fb_t.numpy(), np.asarray(fb_j)
    assert np.isfinite(got).all()
    close = np.isclose(got, want, rtol=RTOL, atol=ATOL).all(-1)
    assert (~close).sum() <= 0.02 * close.size, (~close).sum()
    assert abs(got.mean() - want.mean()) <= 1e-3 * want.mean()


# ---- 2. against the port's render_adaptive ----

@pytest.mark.parametrize("shard", ["samples", "rows"])
def test_one_device_is_bitwise_render_adaptive(cornell, shard):
    fb1, st1 = _single(cornell)
    fb, st = _port(cornell, 1, shard)
    np.testing.assert_array_equal(st["n_samples"], st1["n_samples"])
    np.testing.assert_array_equal(fb.numpy(), fb1.numpy())


@pytest.mark.parametrize("n,h,chunk", [(3, 16, 1 << 21), (2, 16, 16 * 8)])
def test_samples_mode_plan_is_the_single_device_plan(cornell, n, h, chunk):
    fb1, st1 = _single(cornell, h, max_rays_per_chunk=chunk)
    fb, st = _port(cornell, n, "samples", h, max_rays_per_chunk=chunk)
    np.testing.assert_array_equal(st["n_samples"], st1["n_samples"])
    np.testing.assert_allclose(fb.numpy(), fb1.numpy(), rtol=RTOL, atol=ATOL)


# ---- 3. rows mode, guards ----

@pytest.mark.parametrize("n,h", [(8, 13)])
def test_rows_mode_conserves_the_budget(cornell, n, h):
    fb, st = _port(cornell, n, "rows", h)
    counts = st["n_samples"]
    assert fb.shape == (h, 16, 3) and np.isfinite(fb.numpy()).all()
    assert counts.shape == (h, 16) and counts.sum() == h * 16 * SPP
    assert counts.min() >= PILOT
    rows_local = -(-h // n)
    for d in range(n):
        region = counts[d * rows_local : (d + 1) * rows_local]
        assert region.sum() == region.size * SPP
    fu = zt.render.Renderer(samples_per_pixel=SPP, max_ray_bounce_depth=DEPTH).render(
        cornell, 16, h)
    assert abs(fb.numpy().mean() - fu.mean()) < 0.15 * fu.mean()


def test_guards_and_uniform_fallback(cornell):
    mesh = make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="stratified"):
        render_adaptive_sharded(cornell, 8, 8, 8, mesh=mesh, sampler=SamplerKind.STRATIFIED)
    with pytest.raises(ValueError, match="unknown shard mode"):
        render_adaptive_sharded(cornell, 8, 8, 8, mesh=mesh, shard="tiles")
    fb, st = render_adaptive_sharded(cornell, 8, 8, 4, max_depth=2, mesh=mesh, seed=3,
                                     pilot_spp=4, return_stats=True)
    assert (st["n_samples"] == 4).all()
    want = render_sharded(cornell, 8, 8, 4, max_depth=2, mesh=mesh, seed=3)
    np.testing.assert_array_equal(fb.numpy(), want.numpy())
