"""Sharded rendering in the PyTorch port on the CPU (``parallel/``), against
the JAX package's ``parallel/`` and its tests (tests/test_parallel.py).

The port's meshes here are ``make_mesh(n, device="cpu")``: the CPU device n
times, whose shards render in turn (the counterpart of the suite's 8-device
virtual CPU mesh, on which the JAX side runs).

  1. ``make_mesh``: n CPU entries (default ``ZWRT_CPU_DEVICES``); a CUDA
     mesh without a GPU raises, as does a mesh that names the card.
     ``scene.compiled_on`` puts every tensor of a scene on another device
     (the meta device here), once per (scene, device).
  2. ``render_sharded`` against JAX's ``render_sharded`` at the same n (its
     XLA path on the CPU) at cornell 16x16, 8 spp, depth 3, n in {2, 4, 8}
     (n = 1 is the port's unsharded render, 3. below), both modes, within rtol 1e-5 / atol 1e-6 but the floor/red-wall
     edge pixels (tests/test_torch_render.py's EDGE_PIXELS, the image
     diagonal's last quarter, whose camera rays XLA's contracted
     multiply-adds decide otherwise), on which alone the two packages'
     single-device renders at these settings differ (the witness here);
     shrek_quads (the bounce kernel's regenerating mode) in samples mode
     with SHREK_EDGE_PIXELS of tests/test_torch_images.py; a spp (5) and a
     height (13) that 8 devices do not divide; a small
     ``max_rays_per_chunk`` (several bands, samples that must not be
     counted twice).
  3. Against the port itself: a one-device mesh is bitwise
     ``Renderer.render`` in both modes, first call and the cost-sorted
     second; the sorted steady state equals the first call on 4 devices (the
     bound of test_torch_render.py's sorted plan); the plans die with their
     scene; an unknown mode and the u32 ray-id bound raise.
"""

import gc
import weakref

import numpy as np
import pytest
import torch

from test_torch_reference_native import reference_decodes_with_stb  # noqa: F401
import zig_weekend_raytracer_tpu as zj
import zig_weekend_raytracer_tpu_torch as zt
from zig_weekend_raytracer_tpu.parallel import make_mesh as jmesh
from zig_weekend_raytracer_tpu.parallel import render_sharded as jrender
from zig_weekend_raytracer_tpu_torch.parallel import make_mesh, render_sharded, resolve_mesh
from zig_weekend_raytracer_tpu_torch.parallel import render as prender
from zig_weekend_raytracer_tpu_torch.scene import compiled_on

RTOL, ATOL = 1e-5, 1e-6
SORTED_RTOL, SORTED_ATOL = 2e-5, 2e-6  # test_torch_render.py's sorted plan
SHREK_EDGE_PIXELS = ((13, 3), (14, 5), (6, 13))  # test_torch_images.py, shrek 16x16


@pytest.fixture(scope="module")
def cornell():
    return zt.models.load_scene("cornell_box", device="cpu"), zj.models.load_scene("cornell_box")


def _off(pixels, h, w):
    keep = np.ones((h, w), bool)
    for x, y in pixels:
        keep[y, x] = False
    return keep


def _edge(h, w):
    """Cornell's floor/red-wall edge pixels: the image diagonal's last
    quarter, test_torch_render.py's EDGE_PIXELS (12, 12)..(14, 14) at 16x16
    and 2 spp, which more samples per pixel extend to (15, 15)."""
    return _off([(k, k) for k in range(3 * w // 4, min(h, w))], h, w)


def _differ(a, b):
    return ~np.isclose(a, b, rtol=RTOL, atol=ATOL).all(-1)


# ---- 1. meshes and scene placement ----

def test_make_mesh(monkeypatch):
    cpu = torch.device("cpu")
    assert make_mesh(3, device="cpu") == (cpu,) * 3
    monkeypatch.setenv("ZWRT_CPU_DEVICES", "5")
    assert make_mesh(device="cpu") == (cpu,) * 5
    monkeypatch.delenv("ZWRT_CPU_DEVICES")
    assert make_mesh(device="cpu") == (cpu,)
    assert resolve_mesh(["cpu", cpu], cpu) == (cpu, cpu)
    with pytest.raises(ValueError, match="at least one"):
        make_mesh(0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh(2, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_mesh(("cuda:0",), cpu)
    scene = zt.models.load_scene("cornell_box", device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        render_sharded(scene, 4, 4, 2, max_depth=2, mesh=("cuda",) * 2)


def test_compiled_on_places_every_tensor():
    cs = zt.models.load_scene("balls", device="cpu").compiled
    assert compiled_on(cs, cs.device) is cs
    meta = torch.device("meta")
    moved = compiled_on(cs, meta)
    assert compiled_on(cs, meta) is moved and moved.device == meta
    n_tensors = 0
    for name in cs.__dataclass_fields__:
        a, b = getattr(cs, name), getattr(moved, name)
        flat_a = list(a) if isinstance(a, tuple) else [a]
        flat_b = list(b) if isinstance(b, tuple) else [b]
        for x, y in zip(flat_a, flat_b):
            if isinstance(x, torch.Tensor):
                n_tensors += 1
                assert y.device == meta and y.shape == x.shape and y.dtype == x.dtype, name
            elif name != "device":
                assert x == y, name
    assert n_tensors > 40
    ref = weakref.ref(moved)
    del cs, moved
    gc.collect()
    assert ref() is None


# ---- 2. against the JAX package ----

@pytest.mark.parametrize("shard", ["samples", "rows"])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_render_sharded_matches_jax(cornell, shard, n):
    """n = 1 is the port's unsharded render bitwise
    (test_one_device_is_bitwise_the_render), which the witness below holds
    against JAX's."""
    st, sj = cornell
    fb_j = np.asarray(jrender(sj, 16, 16, 8, max_depth=3, mesh=jmesh(n), shard=shard, seed=0))
    fb_t = render_sharded(st, 16, 16, 8, max_depth=3, mesh=make_mesh(n, device="cpu"),
                          shard=shard, seed=0).numpy()
    assert fb_t.shape == (16, 16, 3) and np.isfinite(fb_t).all()
    keep = _edge(16, 16)
    np.testing.assert_allclose(fb_t[keep], fb_j[keep], rtol=RTOL, atol=ATOL)


def test_edge_pixels_are_the_unsharded_renders(cornell):
    """The witness of the exemption: the two packages' single-device renders
    at these settings differ on the edge pixels only."""
    st, sj = cornell
    fb_j = np.asarray(zj.render.Renderer(samples_per_pixel=8, max_ray_bounce_depth=3).render(
        sj, 16, 16))
    fb_t = zt.render.Renderer(samples_per_pixel=8, max_ray_bounce_depth=3).render(st, 16, 16)
    assert not (_differ(fb_t, fb_j) & _edge(16, 16)).any()


def test_render_sharded_image_scene_matches_jax():
    st = zt.models.load_scene("shrek_quads", device="cpu")
    fb_j = np.asarray(jrender(zj.models.load_scene("shrek_quads"), 16, 16, 2, max_depth=3,
                              mesh=jmesh(2), shard="samples", seed=0))
    fb_t = render_sharded(st, 16, 16, 2, max_depth=3, mesh=make_mesh(2, device="cpu"),
                          shard="samples", seed=0).numpy()
    assert np.isfinite(fb_t).all()
    keep = _off(SHREK_EDGE_PIXELS, 16, 16)
    np.testing.assert_allclose(fb_t[keep], fb_j[keep], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shard,h,spp", [("samples", 16, 5), ("rows", 13, 8)])
def test_non_dividing_shards_match_jax(cornell, shard, h, spp):
    st, sj = cornell
    fb_j = np.asarray(jrender(sj, 16, h, spp, max_depth=3, mesh=jmesh(8), shard=shard, seed=0))
    fb_t = render_sharded(st, 16, h, spp, max_depth=3, mesh=make_mesh(8, device="cpu"),
                          shard=shard, seed=0).numpy()
    assert fb_t.shape == (h, 16, 3)
    keep = _edge(h, 16)
    np.testing.assert_allclose(fb_t[keep], fb_j[keep], rtol=RTOL, atol=ATOL)


def test_chunked_bands_count_no_sample_twice(cornell):
    """spp 10 over 2 devices in bands of 4 rows at 5 samples per lane (JAX
    tests/test_parallel.py:221): each device stops at its own slice."""
    st, sj = cornell
    kw = dict(max_depth=3, shard="samples", seed=0, max_rays_per_chunk=192)
    assert zt.render.Renderer(max_rays_per_chunk=192).regen_geometry(8, 8, 5) == (5, 4)
    fb_t = render_sharded(st, 8, 8, 10, mesh=make_mesh(2, device="cpu"), **kw).numpy()
    fb_j = np.asarray(jrender(sj, 8, 8, 10, mesh=jmesh(2), **kw))
    single = zt.render.Renderer(samples_per_pixel=10, max_ray_bounce_depth=3).render(st, 8, 8)
    np.testing.assert_allclose(fb_t, single, rtol=RTOL, atol=ATOL)
    keep = _edge(8, 8)
    np.testing.assert_allclose(fb_t[keep], fb_j[keep], rtol=RTOL, atol=ATOL)


# ---- 3. against the port itself ----

@pytest.mark.parametrize("shard", ["samples", "rows"])
@pytest.mark.parametrize("min_wave", [None, 1])
def test_one_device_is_bitwise_the_render(cornell, shard, min_wave):
    """regen_min_wave=1 opens the cost-sorted plan (s_par = 1): the first
    call measures, the second renders the padded plan."""
    st, _ = cornell
    opts = {} if min_wave is None else {"regen_min_wave": min_wave}
    r = zt.render.Renderer(samples_per_pixel=8, max_ray_bounce_depth=3, seed=1, **opts)
    mesh = make_mesh(1, device="cpu")
    for _ in range(2):
        want = r.render(st, 16, 13)
        got = render_sharded(st, 16, 13, 8, max_depth=3, mesh=mesh, shard=shard, seed=1,
                             regen_min_wave=min_wave).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shard", ["samples", "rows"])
def test_sorted_steady_state_matches_first_call(cornell, shard):
    st, _ = cornell
    prender._plan_cache.pop(st.compiled, None)
    kw = dict(max_depth=3, mesh=make_mesh(4, device="cpu"), shard=shard, seed=0,
              regen_min_wave=1)
    first = render_sharded(st, 16, 16, 8, **kw).numpy()
    (entry,) = prender._plan_cache[st.compiled].values()
    plans = entry["plans"]
    assert len(plans) == 4 and all(p[0].dtype == torch.int32 for bands in plans for p in bands)
    assert all(p[0].shape[0] % 128 == 0 for bands in plans for p in bands)  # dead-item padding
    second = render_sharded(st, 16, 16, 8, **kw).numpy()
    np.testing.assert_allclose(second, first, rtol=SORTED_RTOL, atol=SORTED_ATOL)
    single = zt.render.Renderer(samples_per_pixel=8, max_ray_bounce_depth=3).render(st, 16, 16)
    np.testing.assert_allclose(second, single, rtol=SORTED_RTOL, atol=SORTED_ATOL)


def test_plans_die_with_their_scene():
    scene = zt.models.load_scene("cornell_box", device="cpu")
    render_sharded(scene, 8, 8, 2, max_depth=2, mesh=make_mesh(2, device="cpu"),
                   regen_min_wave=1)
    assert "plans" in next(iter(prender._plan_cache[scene.compiled].values()))
    ref = weakref.ref(scene.compiled)
    del scene
    gc.collect()
    assert ref() is None


def test_guards(cornell):
    st, _ = cornell
    with pytest.raises(ValueError, match="unknown shard mode"):
        render_sharded(st, 4, 4, 2, mesh=make_mesh(2, device="cpu"), shard="columns")
    with pytest.raises(ValueError, match="exceeds u32"):
        render_sharded(st, 256, 256, 1 << 16, mesh=make_mesh(2, device="cpu"))
