"""Adaptive sampling in the PyTorch port on the CPU (``render/adaptive.py``,
``render/adaptive_device.py``; ``--adaptive``), against the JAX package and
its tests (tests/test_adaptive.py, tests/test_adaptive_device.py).

  1. The host functions (``variance_weights``, ``allocate_extra``,
     ``build_adaptive_plan``, ``pick_pilot``) equal JAX's on the same numpy
     inputs, bitwise; the plan partitions each pixel's range.
  2. The device twins: ``build_adaptive_plan_dev`` lane for lane the host
     plan (and JAX's device plan), ``allocate_extra_dev`` conserving and
     capping, ``variance_weights_dev`` within rtol 2e-5 / atol 1e-7 of the
     host's float64 (JAX's own tolerance).
  3. ``render_adaptive`` at cornell 16x16, 32 spp, depth 5 with the
     independent sampler (its jitter keeps off test_torch_fused_render's
     edge rays), under the host plan (``ZWRT_ADAPTIVE_HOST=1``) and the
     device plan, against JAX's (Pallas interpret): the sample-count map
     equal, and the framebuffer within rtol 1e-5 / atol 1e-6 on all but 2%
     of the pixels, the image means within 1e-3.  The uniform renders of
     the two packages at these settings differ the same way, on 3 of the
     256 pixels: XLA's contracted multiply-adds on the CPU send a path
     across a grazing hit that the port's unfused ones do not.  JAX's
     ``test_adaptive_xla_fallback_renders_uniform`` has no counterpart: the
     port has no render without its kernels to fall back to.
  4. Budget and mean, the stratified sampler raising, an atlas image scene
     (the bounce kernel's regenerating mode), Russian roulette composed,
     several bands, as JAX's tests.
  5. The Sobol tables of a launch cover its sample indices past spp
     (``ops/fused_render.py:launch_windows``): the factored sampler at
     the launch's byte count equals ``sobol_pixel_u32`` at every index an
     adaptive plan's lanes render, where spp's byte count falls short.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_reference_native import reference_decodes_with_stb  # noqa: F401
import zig_weekend_raytracer_tpu as zj
import zig_weekend_raytracer_tpu_torch as zt
from zig_weekend_raytracer_tpu.render import adaptive as jad
from zig_weekend_raytracer_tpu.render import adaptive_device as jdev
from zig_weekend_raytracer_tpu.sampling.sampler import SamplerKind as JKind
from zig_weekend_raytracer_tpu_torch.ops import fused_render
from zig_weekend_raytracer_tpu_torch.render import adaptive as tad
from zig_weekend_raytracer_tpu_torch.render import adaptive_device as tdev
from zig_weekend_raytracer_tpu_torch.render.renderer import tile_order_lane_index
from zig_weekend_raytracer_tpu_torch.sampling import sobol as tsob
from zig_weekend_raytracer_tpu_torch.sampling.sampler import SamplerKind

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def cornell():
    return zt.models.load_scene("cornell_box", device="cpu")


# ---- 1. host functions ----

@pytest.mark.parametrize("seed", [0, 1])
def test_variance_weights_equal_jax(seed):
    rng = np.random.default_rng(seed)
    a = rng.random((12, 17, 3)).astype(np.float32)
    b = rng.random((12, 17, 3)).astype(np.float32)
    np.testing.assert_array_equal(tad.variance_weights(a, b), jad.variance_weights(a, b))


@pytest.mark.parametrize("total,cap", [(12 * 17 * 24, 200), (160, 1000), (16 * 50, 10),
                                       (7, 3), (0, 5)])
def test_allocate_extra_equals_jax(total, cap):
    rng = np.random.default_rng(total)
    w = rng.random((12, 17))
    w[rng.random((12, 17)) < 0.2] = 0.0
    got = tad.allocate_extra(w, total, cap)
    np.testing.assert_array_equal(got, jad.allocate_extra(w, total, cap))
    assert got.min() >= 0 and got.max() <= cap
    if total <= cap * w.size:
        assert got.sum() == total


@pytest.mark.parametrize("tile", [None, 32])
@pytest.mark.parametrize("sort_lanes", [False, True])
def test_build_adaptive_plan_equals_jax(tile, sort_lanes):
    rng = np.random.default_rng(3)
    rows, width = (40, 70) if tile else (8, 16)
    n_extra = rng.integers(0, 60, size=(rows, width)).astype(np.int64)
    n_extra[rng.random((rows, width)) < 0.3] = 0
    pilot, lane_cap, blk = 8, 16, 128
    got = tad.build_adaptive_plan(n_extra, 24, pilot, tile, lane_cap, sort_lanes=sort_lanes,
                                  blk=blk)
    want = jad.build_adaptive_plan(n_extra, 24, pilot, tile, lane_cap, sort_lanes=sort_lanes,
                                   blk=blk)
    for a, b in zip(got, want):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    px, py, s0, s1 = got
    live = s1 > s0
    assert ((s1 - s0)[live] <= lane_cap).all() and len(px) % blk == 0
    counts = np.zeros((rows, width, pilot + 60), np.int32)
    for x, y, a, b in zip(px[live], py[live], s0[live], s1[live]):
        counts[y - 24, x, a:b] += 1
    for y in range(rows):
        for x in range(width):
            n = n_extra[y, x]
            assert (counts[y, x, pilot:pilot + n] == 1).all()
            assert not counts[y, x, :pilot].any() and not counts[y, x, pilot + n:].any()


def test_pick_pilot_equals_jax():
    for spp in (2, 3, 4, 5, 8, 16, 32, 64, 100, 128, 1024, 4096):
        assert tad.pick_pilot(spp) == jad.pick_pilot(spp)


# ---- 2. device twins ----

def test_variance_weights_dev_matches_host():
    rng = np.random.RandomState(0)
    a = rng.rand(12, 16, 3).astype(np.float32)
    b = rng.rand(12, 16, 3).astype(np.float32)
    w_host = tad.variance_weights(a, b)
    w_dev = tdev.variance_weights_dev(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert w_dev.dtype == np.float32
    np.testing.assert_allclose(w_dev, w_host, rtol=2e-5, atol=1e-7)


def test_allocate_extra_dev_conserves_and_caps():
    rng = np.random.RandomState(1)
    w = rng.rand(8, 16).astype(np.float32)
    n = tdev.allocate_extra_dev(torch.from_numpy(w), 1000, 40).numpy()
    assert n.dtype == np.int32
    assert n.min() >= 0 and n.max() <= 40 and n.sum() == 1000
    # the cap binds everywhere: every pixel full, the rest unallocated
    n = tdev.allocate_extra_dev(torch.ones((4, 4)), 1000, 10).numpy()
    assert (n == 10).all()
    # a per-pixel cap of 0 keeps those pixels out
    cap = np.full(w.size, 40, np.int32)
    cap[:16] = 0
    n = tdev.allocate_extra_dev(torch.from_numpy(w), 500, torch.from_numpy(cap)).numpy()
    assert not n.reshape(-1)[:16].any() and n.sum() == 500


@pytest.mark.parametrize("sort_lanes", [False, True])
def test_build_plan_dev_matches_host_lane_for_lane(sort_lanes):
    rng = np.random.RandomState(2)
    rows, width = 8, 16
    band_y0, pilot, lane_cap, blk = 3, 4, 12, 64
    n_extra = rng.randint(0, 40, size=(rows, width)).astype(np.int64)
    n_extra[rng.rand(rows, width) < 0.3] = 0
    host = tad.build_adaptive_plan(n_extra, band_y0, pilot, None, lane_cap,
                                   sort_lanes=sort_lanes, blk=blk)
    order = np.argsort(tile_order_lane_index(width, rows, None).reshape(-1), kind="stable")
    m = tdev.plan_lane_budget(rows * width, blk)
    assert m == jdev.plan_lane_budget(rows * width, blk)
    dev = [a.numpy() for a in tdev.build_adaptive_plan_dev(
        torch.from_numpy(n_extra.astype(np.int32)), torch.from_numpy(order), band_y0=band_y0,
        pilot=pilot, lane_cap=lane_cap, sort_lanes=sort_lanes, m_lanes=m, width=width)]
    jax_dev = [np.asarray(a) for a in jdev.build_adaptive_plan_dev(
        jnp.asarray(n_extra.astype(np.int32)), jnp.asarray(order.astype(np.int32)),
        band_y0=band_y0, pilot=pilot, lane_cap=lane_cap, sort_lanes=sort_lanes, m_lanes=m,
        width=width)]
    for a, b in zip(dev, jax_dev):
        np.testing.assert_array_equal(a, b)
    live_h, live_d = host[3] > host[2], dev[3] > dev[2]
    k = int(live_h.sum())
    assert int(live_d.sum()) == k and not live_d[k:].any()
    for a, b in zip(dev, host):
        np.testing.assert_array_equal(a[:k], b[:k])


# ---- 3. the render against JAX's ----

@pytest.mark.parametrize("host_plan", [True, False])
def test_render_adaptive_matches_jax(pallas_interpret, monkeypatch, host_plan):
    if host_plan:
        monkeypatch.setenv("ZWRT_ADAPTIVE_HOST", "1")
    opts = dict(samples_per_pixel=32, max_ray_bounce_depth=5, seed=0)
    fb_j, st_j = zj.render.Renderer(sampler=JKind.INDEPENDENT, **opts).render_adaptive(
        zj.models.load_scene("cornell_box"), 16, 16, return_stats=True)
    fb_t, st_t = zt.render.Renderer(sampler=SamplerKind.INDEPENDENT, **opts).render_adaptive(
        zt.models.load_scene("cornell_box", device="cpu"), 16, 16, return_stats=True)
    assert st_t["pilot"] == st_j["pilot"]
    np.testing.assert_array_equal(st_t["n_samples"], st_j["n_samples"])
    assert st_t["n_samples"].sum() == 32 * 16 * 16
    got, want = fb_t.numpy(), np.asarray(fb_j)
    assert np.isfinite(got).all()
    close = np.isclose(got, want, rtol=RTOL, atol=ATOL).all(-1)
    assert (~close).sum() <= 0.02 * close.size, (~close).sum()
    assert abs(got.mean() - want.mean()) <= 1e-3 * want.mean()


# ---- 4. budget, guards, image scenes, RR, bands ----

def test_adaptive_budget_and_mean(cornell):
    r = zt.render.Renderer(samples_per_pixel=32, max_ray_bounce_depth=5, seed=0)
    fb, stats = r.render_adaptive(cornell, 16, 16, return_stats=True)
    fb = fb.numpy()
    assert stats["n_samples"].sum() == 32 * 16 * 16
    assert stats["n_samples"].min() >= stats["pilot"]
    assert np.isfinite(fb).all()
    fu = r.render(cornell, 16, 16)
    assert abs(fb.mean() - fu.mean()) < 0.15 * fu.mean()


def test_adaptive_stratified_raises(cornell):
    r = zt.render.Renderer(samples_per_pixel=16, max_ray_bounce_depth=3,
                           sampler=SamplerKind.STRATIFIED)
    with pytest.raises(ValueError, match="stratified"):
        r.render_adaptive(cornell, 8, 8)


def test_adaptive_image_scene():
    from zig_weekend_raytracer_tpu_torch.render import integrator

    scene = zt.models.load_scene("shrek_quads", device="cpu")
    r = zt.render.Renderer(samples_per_pixel=16, max_ray_bounce_depth=4, seed=0)
    bands = integrator.trace_paths_regen.bands
    fb, stats = r.render_adaptive(scene, 12, 12, return_stats=True)
    assert integrator.trace_paths_regen.bands == bands + 3  # the bounce kernel's drains
    fb = fb.numpy()
    assert stats["n_samples"].sum() == 16 * 12 * 12
    assert np.isfinite(fb).all()
    fu = r.render(scene, 12, 12)
    assert abs(fb.mean() - fu.mean()) < 0.2 * fu.mean()


def test_adaptive_composes_with_russian_roulette(cornell):
    r = zt.render.Renderer(samples_per_pixel=32, max_ray_bounce_depth=6, seed=0,
                           russian_roulette=2)
    fb, stats = r.render_adaptive(cornell, 12, 12, return_stats=True)
    fb = fb.numpy()
    assert stats["n_samples"].sum() == 32 * 12 * 12
    assert np.isfinite(fb).all()
    base = zt.render.Renderer(samples_per_pixel=32, max_ray_bounce_depth=6,
                              seed=0).render(cornell, 12, 12)
    assert abs(fb.mean() - base.mean()) < 0.15 * base.mean()


@pytest.mark.parametrize("host_plan", [True, False])
def test_adaptive_multiband(cornell, monkeypatch, host_plan):
    if host_plan:
        monkeypatch.setenv("ZWRT_ADAPTIVE_HOST", "1")
    r = zt.render.Renderer(samples_per_pixel=16, max_ray_bounce_depth=4, seed=0,
                           max_rays_per_chunk=16 * 5)
    fb, stats = r.render_adaptive(cornell, 16, 16, return_stats=True)
    ns = stats["n_samples"]
    assert np.isfinite(fb.numpy()).all() and fb.shape == (16, 16, 3)
    for y0, y1 in ((0, 5), (5, 10), (10, 15), (15, 16)):
        assert ns[y0:y1].sum() == 16 * (y1 - y0) * 16, (y0, y1)


# ---- 5. the Sobol tables past spp ----

def test_sobol_tables_cover_the_plan_past_spp():
    """An adaptive plan at spp 64 on 64x64 reaches sample indices in the
    thousands: the launch's tables (``launch_windows``' end of its windows)
    hold two bytes, where spp's one would not reach them, and the factored
    sampler at that byte count equals the bit loops at every index."""
    spp, width = 64, 64
    pilot = tad.pick_pilot(spp)
    cap = min(64 * (spp - pilot), 2**32 // (width * width) - pilot - 1)
    n_extra = np.zeros((width, width), np.int64)
    n_extra[5, 7], n_extra[40, 3] = cap, 100
    px, py, s0, s1 = tad.build_adaptive_plan(n_extra, 0, pilot, None, 2 * (spp - pilot))
    end, _ = fused_render.launch_windows(torch.from_numpy(s0), torch.from_numpy(s1), 1)
    assert end == pilot + cap > spp
    n_bytes = tsob.sobol_sample_bytes(end)
    assert n_bytes == 2 > tsob.sobol_sample_bytes(spp)
    ints, _ = fused_render.launch_params(
        zt.models.load_scene("cornell_box", device="cpu").compiled, 0, zt.dtypes.T_MIN,
        ((0.0,) * 3,) * 6, SamplerKind.SOBOL, width, width, spp, 1, 10, False, end)
    assert ints[15] == n_bytes
    assert fused_render.sobol_smem_bytes(SamplerKind.SOBOL, end) == 2 * n_bytes * 256 * 4
    live = s1 > s0
    lane_px = np.repeat(px[live], s1[live] - s0[live])
    lane_py = np.repeat(py[live], s1[live] - s0[live])
    s = np.concatenate([np.arange(a, b) for a, b in zip(s0[live], s1[live])])
    assert s.max() == end - 1
    log2 = zt.sampling.sampler.sobol_log2_scale(width, width)
    t = lambda a: torch.from_numpy(np.asarray(a, np.int64))
    direct = torch.stack([tsob.sobol_pixel_u32(log2, t(s), t(lane_px), t(lane_py), d)
                          for d in (0, 1)])
    got = tsob.sobol_pixel_u32_factored(tsob.sobol_p_tables(log2, n_bytes), log2, t(s),
                                        t(lane_px), t(lane_py))
    assert torch.equal(got, direct)
    with pytest.raises(ValueError, match="1 bytes"):
        tsob.sobol_pixel_u32_factored(tsob.sobol_p_tables(log2, tsob.sobol_sample_bytes(spp)),
                                      log2, t(s), t(lane_px), t(lane_py))
