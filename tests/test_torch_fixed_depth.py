"""The fixed-depth wavefront of the PyTorch port on the CPU (``textures.py:
texture_value``, ``render/integrator.py:trace_paths``,
``render/renderer.py:_render_band``), against the JAX package's.

  1. ``texture_value`` is bitwise JAX's on 4,096 seeded (texture id, u, v,
     point) over a three-level nested scene with an image child, the nested
     quad of tests/test_textures.py:TestNestedChecker and a nested scene
     with a texture LUT (the atlas is read, not the LUT).
  2. ``Renderer.render`` of the nested quad and of the image-child scene
     (they route to the fixed-depth path), and the fixed-depth path forced
     on cornell_box and balls, against JAX's ``Renderer.render`` (its XLA
     path on the CPU, the path that made tests/golden) at 16x16, 2 spp,
     depth 3: rtol 1e-6 on every pixel but the witnesses, cornell's
     EDGE_PIXELS (test_torch_render.py) and the nested scenes'
     NESTED_WITNESSES, whose witness test shows the JAX package's fused
     multiply-adds put the camera ray off the checkers' x = 0 or y = 0
     lattice plane, where the port's rounded products put it on it;
     ``render_supersampled`` of the nested quad the same way.
  3. Russian roulette 2 and the clamp 1.0 on a nested scene with an image
     child and a LUT render bitwise as with both off (JAX's gate on this
     path: off on every image scene).
  4. ``render_sharded`` and ``render_batch_sharded`` on make_mesh(n,
     device="cpu"), n in {2, 4}, both modes, against JAX's
     ``render_sharded`` on its virtual CPU devices; a progressive render
     interrupted and resumed is bitwise the uninterrupted one.
  5. ``render_adaptive`` and ``render_adaptive_sharded`` log the warning
     and return the uniform render and its uniform sample map.
  6. The nested AOV albedo equals JAX's eager AOV pass.
  7. On CPU tensors the path's trace is the closest hit's plain version:
     no kernel launches, and the kernel launchers refuse nested scenes.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zig_weekend_raytracer_tpu as zj
import zig_weekend_raytracer_tpu_torch as zt
from test_torch_reference_native import reference_decodes_with_stb  # noqa: F401
from test_torch_render import EDGE_PIXELS
from test_torch_texlut import _jax_compile
from zig_weekend_raytracer_tpu.math.v3 import V3 as JV3
from zig_weekend_raytracer_tpu.parallel import make_mesh as jmesh
from zig_weekend_raytracer_tpu.parallel import render_sharded as jrender
from zig_weekend_raytracer_tpu.textures import texture_value as j_texture_value
from zig_weekend_raytracer_tpu_torch.math.v3 import V3
from zig_weekend_raytracer_tpu_torch.ops import bounce as tbounce
from zig_weekend_raytracer_tpu_torch.ops import closest_hit as ch
from zig_weekend_raytracer_tpu_torch.ops import fused_render
from zig_weekend_raytracer_tpu_torch.ops import trace as ttrace
from zig_weekend_raytracer_tpu_torch.parallel import (
    make_mesh,
    render_adaptive_sharded,
    render_batch_sharded,
    render_sharded,
)
from zig_weekend_raytracer_tpu_torch.render import integrator
from zig_weekend_raytracer_tpu_torch.render.progressive import ProgressiveRenderer
from zig_weekend_raytracer_tpu_torch.textures import texture_value

W = H = 16
SPP, DEPTH = 2, 3
RTOL = 1e-6
LUT = 48  # a texel budget below the image's 64 texels: a lossy LUT
# (x, y) of the nested scenes' pixels at 16x16@2 whose camera ray lies on
# the x = 0 or y = 0 lattice plane in the port, off it in the JAX package
# (_plane_witnesses, test_nested_witness_is_the_camera_ray)
NESTED_WITNESSES = ((1, 7), (7, 1))


def _image():
    return np.random.default_rng(7).integers(0, 256, (8, 8, 3), dtype=np.uint8)


def _nested(pkg, image=False, lut=0):
    """tests/test_textures.py:TestNestedChecker's quad (red / green inner
    checker in a blue outer one) under a white sky, with a lamp; with
    ``image`` a third level whose odd child is an image."""
    b = pkg.scene.SceneBuilder()
    red, green = b.solid_color((1.0, 0.0, 0.0)), b.solid_color((0.0, 1.0, 0.0))
    if image:
        green = b.checkerboard(8.0, green, b.image_texture(_image()))
    inner = b.checkerboard(2.0, red, green)
    outer = b.checkerboard(0.25, inner, b.solid_color((0.0, 0.0, 1.0)))
    b.add(b.quad((-4, -4, 0), (8, 0, 0), (0, 8, 0), b.lambertian(outer)))
    b.add(b.sphere((1.5, 1.0, 2.0), 0.8, b.diffuse_light(b.solid_color((4.0, 4.0, 4.0)))))
    b.add(b.sphere((-1.5, -1.0, 1.0), 1.0, b.lambertian(inner)))
    b.set_camera(pkg.scene.Camera(look_from=(0, 0, 9), look_at=(0, 0, 0), vfov_degrees=60))
    b.set_background((1.0, 1.0, 1.0))
    if pkg is zj:
        return _jax_compile(b.compile, lut)
    return b.compile(device="cpu", texture_lut=lut)


@pytest.fixture(scope="module")
def scenes():
    out = {}
    for name, kw in (("nested", {}), ("nested_image", {"image": True}),
                     ("nested_lut", {"image": True, "lut": LUT})):
        out[name] = (_nested(zj, **kw), _nested(zt, **kw))
    for name in ("cornell_box", "balls"):
        out[name] = (zj.models.load_scene(name), zt.models.load_scene(name, device="cpu"))
    return out


def _jax_render(sj, spp=SPP, depth=DEPTH, **kw):
    return np.asarray(zj.render.Renderer(samples_per_pixel=spp, max_ray_bounce_depth=depth,
                                         **kw).render(sj, W, H))


def _fixed_depth(st, spp=SPP, depth=DEPTH, **kw):
    """The port's fixed-depth path, whatever the scene."""
    r = zt.render.Renderer(samples_per_pixel=spp, max_ray_bounce_depth=depth, **kw)
    return r._render_fixed_depth(st, W, H).numpy()


def _keep(pixels):
    keep = np.ones((H, W), bool)
    for x, y in pixels:
        keep[y, x] = False
    return keep


# ---- 1. the general texture walk ----

@pytest.mark.parametrize("name", ["nested", "nested_image", "nested_lut"])
def test_texture_value_is_bitwise_jax(scenes, name):
    sj, st = scenes[name]
    cs_j, cs_t = sj.compiled, st.compiled
    assert cs_t.has_nested_checker and cs_j.has_nested_checker
    assert cs_t.has_image_textures == cs_j.has_image_textures == (name != "nested")
    assert bool(cs_t.tex_lut_dims) == (name == "nested_lut")
    rng = np.random.default_rng(11)
    n = 4096
    tex = rng.integers(0, cs_t.n_textures, n).astype(np.int32)
    u, v = (rng.uniform(-0.2, 1.2, n).astype(np.float32) for _ in range(2))
    p = rng.uniform(-6.0, 6.0, (3, n)).astype(np.float32)
    p[:, ::7] = np.round(p[:, ::7])  # on lattice boundaries too
    got = texture_value(cs_t, torch.from_numpy(tex), torch.from_numpy(u), torch.from_numpy(v),
                        V3(*(torch.from_numpy(c) for c in p)))
    want = j_texture_value(cs_j, jnp.asarray(tex), jnp.asarray(u), jnp.asarray(v),
                           JV3(*(jnp.asarray(c) for c in p)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # every leaf of the walk was reached
    colours = {tuple(c) for c in np.stack([g.numpy() for g in got], -1).round(4)}
    assert {(1.0, 0.0, 0.0), (0.0, 0.0, 1.0)} <= colours


def test_texture_value_reads_the_atlas_not_the_lut(scenes):
    """The LUT is box-downsampled: the walk's texel is the atlas's."""
    _, st = scenes["nested_lut"]
    cs = st.compiled
    img = int(np.flatnonzero(cs.tex_type.numpy() == zt.scene.TEX_IMAGE)[0])
    u, v = (torch.linspace(0.0, 1.0, 64) for _ in range(2))
    v = v.flip(0)
    zero = torch.zeros(64)
    got = texture_value(cs, torch.full((64,), img, dtype=torch.int32), u, v, V3(zero, zero, zero))
    atlas = zt.textures.atlas_lookup(cs, torch.zeros(64, dtype=torch.int32), u, v)
    lut = zt.textures.lut_lookup(cs, torch.zeros(64, dtype=torch.int32), u, v)
    for g, a in zip(got, atlas):
        assert torch.equal(g, a)
    assert any(not torch.equal(g, l) for g, l in zip(got, lut))


# ---- 2. renders against the JAX package ----

@pytest.mark.parametrize("name", ["nested", "nested_image"])
def test_nested_render_matches_jax(scenes, name):
    sj, st = scenes[name]
    assert not tbounce.supports_bounce_kernel(st.compiled)
    bounces = integrator.trace_paths.bounces
    fb_t = zt.render.Renderer(samples_per_pixel=SPP, max_ray_bounce_depth=DEPTH).render(st, W, H)
    assert 1 <= integrator.trace_paths.bounces - bounces <= DEPTH
    fb_j = _jax_render(sj)
    assert fb_t.shape == (H, W, 3) and np.isfinite(fb_t).all() and fb_t.max() > 0
    keep = _keep(NESTED_WITNESSES)
    np.testing.assert_allclose(fb_t[keep], fb_j[keep], rtol=RTOL, atol=0)


def _plane_witnesses(sj, st, w, h, spp, camera_j=None, camera_t=None):
    """(x, y) of the pixels with a camera ray whose x or y direction is
    exactly 0 in the port's generation (rounded products) and not in the
    JAX package's jitted one (fused multiply-adds): its hit lies on the
    checkers' x = 0 or y = 0 lattice plane in one and off it in the other,
    so the parity, and the colour, can flip."""
    from zig_weekend_raytracer_tpu.render.camera import camera_params as jparams
    from zig_weekend_raytracer_tpu.render.camera import generate_rays as jgen
    from zig_weekend_raytracer_tpu.render.renderer import ray_grid as jgrid
    from zig_weekend_raytracer_tpu_torch.render.camera import camera_params, generate_rays
    from zig_weekend_raytracer_tpu_torch.render.renderer import ray_grid

    camera_j, camera_t = camera_j or sj.camera, camera_t or st.camera
    px, py, sidx, rid = ray_grid(w, h, 0, h, 0, spp)
    _, d_t, _ = generate_rays(camera_params(camera_t, w, h), False, zt.sampling.SamplerKind.SOBOL,
                              0, rid, px, py, sidx, spp, w, h)

    @jax.jit
    def jax_dir():
        jpx, jpy, jsidx, jrid = jgrid(w, h, jnp.int32(0), h, jnp.int32(0), spp)
        d = jgen(jparams(camera_j, w, h), False, zj.sampling.SamplerKind.SOBOL,
                 jnp.uint32(0), jrid, jpx, jpy, jsidx, spp, w, h)[1]
        return d.x, d.y

    lanes = np.zeros(rid.shape[0], bool)
    for c_t, c_j in zip((d_t.x, d_t.y), jax_dir()):
        lanes |= (c_t.numpy() == 0.0) & (np.asarray(c_j) != 0.0)
    return {(int(x), int(y)) for x, y in zip(px.numpy()[lanes], py.numpy()[lanes])}


def test_nested_witness_is_the_camera_ray(scenes):
    """NESTED_WITNESSES are the pixels whose camera ray lies on a lattice
    plane in the port and off it in the JAX package
    (``_plane_witnesses``); every pixel whose colour differs is one."""
    sj, st = scenes["nested"]
    assert _plane_witnesses(sj, st, W, H, SPP) == set(NESTED_WITNESSES)
    fb_t = zt.render.Renderer(samples_per_pixel=SPP, max_ray_bounce_depth=DEPTH).render(st, W, H)
    fb_j = _jax_render(sj)
    differ = ~np.isclose(fb_t, fb_j, rtol=RTOL, atol=0).all(-1)
    assert differ.any()
    assert {(int(x), int(y)) for y, x in np.argwhere(differ)} <= set(NESTED_WITNESSES)


@pytest.mark.parametrize("name", ["cornell_box", "balls"])
def test_fixed_depth_path_matches_jax(scenes, name):
    sj, st = scenes[name]
    launches = ch.closest_hit.launches
    fb_t = _fixed_depth(st)
    fb_j = _jax_render(sj)
    assert ch.closest_hit.launches == launches  # CPU tensors: the plain walk
    assert np.isfinite(fb_t).all() and fb_t.max() > 0
    keep = _keep(EDGE_PIXELS if name == "cornell_box" else ())
    np.testing.assert_allclose(fb_t[keep], fb_j[keep], rtol=RTOL, atol=0)


def test_render_band_masks_samples_past_the_limit(scenes):
    from zig_weekend_raytracer_tpu_torch.render.renderer import _render_band

    _, st = scenes["nested"]
    kw = dict(width=W, height=H, band_rows=H, spp=4, max_depth=DEPTH,
              sampler=zt.sampling.SamplerKind.SOBOL, has_dof=False)
    whole = _render_band(st, 0, 0, 0, spp_chunk=4, **kw)
    first = _render_band(st, 0, 0, 0, spp_chunk=4, sample_limit=2, **kw)
    torch.testing.assert_close(first, _render_band(st, 0, 0, 0, spp_chunk=2, **kw),
                               rtol=0, atol=0)
    torch.testing.assert_close(whole - first, _render_band(st, 0, 0, 2, spp_chunk=2, **kw),
                               rtol=1e-6, atol=1e-6)


# ---- 3. the estimator options' gate ----

def test_rr_and_clamp_are_off_on_image_scenes(scenes):
    _, st = scenes["nested_lut"]
    assert st.compiled.tex_lut_dims and st.compiled.has_image_textures
    off = zt.render.Renderer(samples_per_pixel=4, max_ray_bounce_depth=6).render(st, W, H)
    on = zt.render.Renderer(samples_per_pixel=4, max_ray_bounce_depth=6, russian_roulette=2,
                            clamp_indirect=1.0).render(st, W, H)
    np.testing.assert_array_equal(on, off)
    # the kernels' gate would take both on a LUT scene
    assert integrator.estimator_options(st.compiled, 2, 1.0) == (2, 1.0)


# ---- 4. sharded and progressive ----

@pytest.mark.parametrize("shard", ["samples", "rows"])
@pytest.mark.parametrize("n", [2, 4])
def test_render_sharded_matches_jax(scenes, shard, n):
    sj, st = scenes["nested_image"]
    fb_j = np.asarray(jrender(sj, W, H, 6, max_depth=DEPTH, mesh=jmesh(n), shard=shard, seed=0,
                              max_rays_per_chunk=W * H * 4))
    mesh = make_mesh(n, device="cpu")
    fb_t = render_sharded(st, W, H, 6, max_depth=DEPTH, mesh=mesh, shard=shard, seed=0,
                          max_rays_per_chunk=W * H * 4).numpy()
    keep = _keep(NESTED_WITNESSES)
    np.testing.assert_allclose(fb_t[keep], fb_j[keep], rtol=1e-5, atol=1e-6)
    # a batch of samples [2, 6): the same sums as the sharded render's
    batch = render_batch_sharded(st, W, H, 6, 2, 4, max_depth=DEPTH, mesh=mesh, shard=shard,
                                 max_rays_per_chunk=W * H * 4)
    first = render_batch_sharded(st, W, H, 6, 0, 2, max_depth=DEPTH, mesh=mesh, shard=shard,
                                 max_rays_per_chunk=W * H * 4)
    np.testing.assert_allclose(((first + batch) / 6).numpy(), fb_t, rtol=1e-5, atol=1e-6)


def test_progressive_resume_is_bitwise(scenes, tmp_path):
    _, st = scenes["nested"]
    base = zt.render.Renderer(samples_per_pixel=6, max_ray_bounce_depth=DEPTH, seed=2)
    whole = ProgressiveRenderer(base, str(tmp_path / "whole.npz")).render(st, W, H, batch_spp=2)
    np.testing.assert_allclose(whole, base.render(st, W, H), rtol=1e-5, atol=1e-7)
    ck = str(tmp_path / "ck.npz")

    class Stop(Exception):
        pass

    def bail(done, _img):
        if done >= 2:
            raise Stop

    with pytest.raises(Stop):
        ProgressiveRenderer(base, ck).render(st, W, H, batch_spp=2, on_batch=bail)
    assert int(np.load(ck)["samples_done"]) == 2
    np.testing.assert_array_equal(ProgressiveRenderer(base, ck).render(st, W, H, batch_spp=2),
                                  whole)


# ---- 5. adaptive renders fall back to uniform ----

def test_adaptive_renders_uniformly(scenes, caplog):
    _, st = scenes["nested"]
    r = zt.render.Renderer(samples_per_pixel=8, max_ray_bounce_depth=DEPTH)
    with caplog.at_level(logging.WARNING, logger="zwrt"):
        fb, stats = r.render_adaptive(st, W, H, return_stats=True)
    assert any("rendering uniformly at 8 spp" in m for m in caplog.messages)
    np.testing.assert_array_equal(fb.numpy(), r.render(st, W, H))
    assert (stats["n_samples"] == 8).all() and stats["n_samples"].shape == (H, W)
    caplog.clear()
    mesh = make_mesh(2, device="cpu")
    with caplog.at_level(logging.WARNING, logger="zwrt"):
        fb, stats = render_adaptive_sharded(st, W, H, 8, max_depth=DEPTH, mesh=mesh,
                                            return_stats=True)
    assert any("rendering uniformly at 8 spp" in m for m in caplog.messages)
    np.testing.assert_array_equal(
        fb.numpy(), render_sharded(st, W, H, 8, max_depth=DEPTH, mesh=mesh).numpy())
    assert (stats["n_samples"] == 8).all()


# ---- 6. the AOV pass ----

def test_nested_aov_albedo_equals_eager_jax(scenes):
    from zig_weekend_raytracer_tpu.render.aov import render_aovs as j_render_aovs
    from zig_weekend_raytracer_tpu_torch.render.aov import render_aovs

    sj, st = scenes["nested_image"]
    got = render_aovs(st, W, H, spp=4)
    with jax.disable_jit():
        want = j_render_aovs(sj, W, H, spp=4)
    np.testing.assert_array_equal(got["albedo"].numpy(), np.asarray(want["albedo"]))
    np.testing.assert_array_equal(got["coverage"].numpy(), np.asarray(want["coverage"]))


# ---- 7. the CPU path and the kernels' refusals ----

def test_cpu_path_launches_nothing_and_kernels_refuse_nested(scenes):
    _, st = scenes["nested_image"]
    calls = ttrace.closest_hit.calls
    zt.render.Renderer(samples_per_pixel=1, max_ray_bounce_depth=2).render(st, 4, 4)
    assert ttrace.closest_hit.calls > calls and ch.closest_hit.launches == 0
    assert not tbounce.supports_fused_render(st.compiled)
    lanes = torch.zeros(4, dtype=torch.int32)
    kw = dict(camera_consts=zt.render.camera.camera_consts(st.camera, 2, 2),
              sampler=zt.sampling.SamplerKind.SOBOL, width=2, height=2, spp=1, stride=1,
              max_depth=2, has_dof=False)
    with pytest.raises(NotImplementedError, match="nested checkers"):
        fused_render._check_supported(st.compiled)
    with pytest.raises(ValueError, match="fixed-depth"):
        integrator.trace_paths_regen(st.compiled, kw.pop("camera_consts"), 0, lanes, lanes,
                                     lanes, lanes, **kw)


def test_supersampled_nested_render_matches_jax(scenes):
    """render_supersampled takes the fixed-depth path through render_device:
    8x8 at k = 2 (16x16 subpixels, 1 spp each, the camera shifted half a
    subpixel) against JAX's, but the pixels over a subpixel witness of
    ``_plane_witnesses``."""
    import dataclasses

    sj, st = scenes["nested"]
    fb_t = zt.render.Renderer(samples_per_pixel=4, max_ray_bounce_depth=DEPTH
                              ).render_supersampled(st, 8, 8, k=2).numpy()
    fb_j = np.asarray(zj.render.Renderer(samples_per_pixel=4, max_ray_bounce_depth=DEPTH
                                         ).render_supersampled(sj, 8, 8, k=2))
    assert fb_t.shape == (8, 8, 3) and np.isfinite(fb_t).all()
    shift = lambda cam: dataclasses.replace(cam, raster_shift=(0.5, 0.5))
    sub = _plane_witnesses(sj, st, 16, 16, 1, shift(sj.camera), shift(st.camera))
    assert sub
    keep = np.ones((8, 8), bool)
    for x, y in sub:
        keep[y // 2, x // 2] = False
    np.testing.assert_allclose(fb_t[keep], fb_j[keep], rtol=RTOL, atol=0)
