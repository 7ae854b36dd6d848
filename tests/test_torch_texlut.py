"""The texture LUT and image emitters in the PyTorch port on the CPU, against
the JAX package (``--texture_lut=N``, ``ZWRT_TEX_LUT``).

With a texel budget every image is box-downsampled to at most N texels and
packed into one table; the whole-render kernel then renders image scenes,
reading each texel from the LUT at the hit.  Below an image's native size
the LUT is lossy by design, so the port is held to JAX's kernel at the
same budget (JAX's XLA integrator reads the atlas).

  1. ``_box_downsample`` / ``_build_tex_lut`` bitwise equal to JAX's for
     several images and budgets, sub-native included (JAX's (R, 128) table
     taken flat).
  2. ``lut_flat_index`` / ``lut_lookup`` bitwise on seeded (img, u, v).
  3. The compiled LUT scene's tables equal JAX's, and
     ``compiled_from_arrays`` carries them.
  4. Routing: ``supports_fused_render`` and ``supports_bounce_kernel`` on
     scenes without images, image scenes with and without a LUT, image
     emitters with and without one, and nested checkers (neither kernel:
     the fixed-depth path, tests/test_torch_fixed_depth.py); the
     kernels' packed image table (``image_args``) is the table the plain
     fetch reads.
  5. Renders of tests/test_texlut.py's image scene at 16x16, 4 spp, depth
     5 through the whole-render path against JAX's kernel (Pallas
     interpret) at the same budget, native and 8 texels, within rtol 3e-5
     / atol 3e-6 (the JAX kernel's reassociation; seen: bitwise), and at
     the native budget bitwise equal to the port's own atlas render (the
     bounce kernel's path).  A tree + image scene the same way.  The
     checker-of-image scene against JAX's XLA integrator run eagerly (its
     image quad lies on a checker lattice plane: see the test).
  6. An image-textured emitter with and without a LUT against JAX's XLA
     integrator (``ZWRT_NO_PALLAS=1``) within rtol 1e-5 / atol 1e-6.
  7. earth with an 8192-texel LUT against JAX's kernel under the
     sphere-UV allowance of tests/test_pallas.py:127-152 (the JAX kernel's
     polynomial acos/atan2 pick a neighbouring texel on isolated pixels):
     at most 2% of pixels outside rtol 3e-5 / atol 3e-6, none by 0.1 or
     more, means within 1e-3 relative.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zig_weekend_raytracer_tpu as zj
import zig_weekend_raytracer_tpu_torch as zt
from test_torch_images import _uv_cases
from test_torch_reference_native import reference_decodes_with_stb  # noqa: F401
from test_torch_scene import _assert_same
from zig_weekend_raytracer_tpu import scene as jscene
from zig_weekend_raytracer_tpu import textures as jtex
from zig_weekend_raytracer_tpu.ops import pallas_bounce as jpb
from zig_weekend_raytracer_tpu.ops.trace import _use_pallas_backend
from zig_weekend_raytracer_tpu_torch import scene as tscene
from zig_weekend_raytracer_tpu_torch import textures as ttex
from zig_weekend_raytracer_tpu_torch.ops import bounce as tbounce
from zig_weekend_raytracer_tpu_torch.ops import fused_render as tfused
from zig_weekend_raytracer_tpu_torch.render import integrator
from zig_weekend_raytracer_tpu_torch.scene import ARRAY_FIELDS, STATIC_FIELDS, compiled_from_arrays

RTOL, ATOL = 3e-5, 3e-6          # JAX kernel order: reassociation
XLA_RTOL, XLA_ATOL = 1e-5, 1e-6  # the port's order is the XLA integrator's
NATIVE = 10_000                  # a budget above every test image's size


def _checker_img(h=4, w=4):
    img = np.zeros((h, w, 3), np.uint8)
    img[::2, ::2] = (200, 40, 40)
    img[1::2, 1::2] = (40, 200, 40)
    return img


def _image_scene(mod, nested_checker_child=False):
    """tests/test_texlut.py:_image_scene, for either package."""
    b = mod.scene.SceneBuilder()
    img = _checker_img()
    if nested_checker_child:
        m_img = b.lambertian(b.checkerboard(0.5, b.image_texture(img),
                                            b.solid_color((0.2, 0.2, 0.8))))
    else:
        m_img = b.lambertian(b.image_texture(img))
    m_gray = b.lambertian(b.solid_color((0.6, 0.6, 0.6)))
    b.add(b.quad((-4, -1, -4), (8, 0, 0), (0, 0, 8), m_gray))
    b.add(b.quad((-2, 0, -2), (4, 0, 0), (0, 4, 0), m_img))
    b.add(b.sphere((2.5, 1, 1), 0.8, m_img))
    b.set_background((0.6, 0.7, 0.9))
    b.set_camera(mod.scene.Camera(look_from=(0, 2, 8), look_at=(0, 1, 0)))
    return b


def _tree_scene(mod):
    """tests/test_texlut.py:test_lut_render_tree_scene's scene."""
    rng = np.random.default_rng(7)
    b = mod.scene.SceneBuilder()
    m_img = b.lambertian(b.image_texture(_checker_img()))
    m_gray = b.lambertian(b.solid_color((0.6, 0.6, 0.6)))
    b.add(b.sphere((-3, 0, 0), 3.0, m_img))
    for _ in range(80):
        b.add(b.sphere(rng.uniform(-12, 12, 3), rng.uniform(0.3, 1.0), m_gray))
    b.use_bvh(True, min_prims=2)
    b.set_camera(mod.scene.Camera(look_from=(0, 0, 25), look_at=(0, 0, 0)))
    b.set_background((0.7, 0.8, 1.0))
    return b


def _emitter_scene(mod):
    """tests/test_texlut.py:test_lut_emissive_image_in_kernel's scene: an
    image-textured quad lamp over a gray floor."""
    b = mod.scene.SceneBuilder()
    m_lamp = b.diffuse_light(b.image_texture(_checker_img()))
    m_gray = b.lambertian(b.solid_color((0.6, 0.6, 0.6)))
    b.add(b.quad((-4, -1, -4), (8, 0, 0), (0, 0, 8), m_gray))
    b.add(b.quad((-2, 0, -2), (4, 0, 0), (0, 4, 0), m_lamp))
    b.set_background((0.0, 0.0, 0.0))
    b.set_camera(mod.scene.Camera(look_from=(0, 2, 8), look_at=(0, 1, 0)))
    return b


def _jax_compile(build, budget):
    """A JAX scene compiled with ZWRT_TEX_LUT=budget (0: none)."""
    if budget:
        os.environ["ZWRT_TEX_LUT"] = str(budget)
    try:
        return build()
    finally:
        os.environ.pop("ZWRT_TEX_LUT", None)


def _jax_render(scene, w, spp, depth, pallas=True):
    key = "ZWRT_PALLAS_INTERPRET" if pallas else "ZWRT_NO_PALLAS"
    os.environ[key] = "1"
    _use_pallas_backend.cache_clear()
    try:
        return np.asarray(zj.render.Renderer(
            samples_per_pixel=spp, max_ray_bounce_depth=depth, seed=0).render(scene, w, w))
    finally:
        del os.environ[key]
        _use_pallas_backend.cache_clear()


def _port_render(scene, w, spp, depth):
    return zt.render.Renderer(samples_per_pixel=spp, max_ray_bounce_depth=depth).render(scene, w, w)


# ---- 1. the LUT build ----

@pytest.mark.parametrize("h,w,budget", [
    (4, 4, NATIVE), (30, 29, 100), (31, 17, 8), (6, 5, 1), (292, 300, 8192),
])
def test_box_downsample_bitwise(h, w, budget):
    im = np.random.default_rng(h * w + budget).integers(0, 256, (h, w, 3), np.uint8)
    got, want = tscene._box_downsample(im, budget), jscene._box_downsample(im, budget)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    assert got.shape[0] * got.shape[1] <= budget
    np.testing.assert_array_equal(got, want)
    if h * w <= budget:
        assert got is im


@pytest.mark.parametrize("budget", [NATIVE, 100, 8, 1])
def test_build_tex_lut_bitwise(budget):
    rng = np.random.default_rng(budget)
    imgs = [rng.integers(0, 256, s, np.uint8) for s in ((4, 4, 3), (13, 9, 3), (7, 30, 3))]
    tab, dims = tscene._build_tex_lut(imgs, budget)
    tab_j, dims_j = jscene._build_tex_lut(imgs, budget)
    assert dims == dims_j and tab.dtype == np.int32 and tab.ndim == 1
    np.testing.assert_array_equal(tab, np.asarray(tab_j).reshape(-1))


# ---- 2. the LUT fetch ----

def _two_image_lut_scenes(budget):
    rng = np.random.default_rng(3)
    imgs = [rng.integers(0, 256, (5, 7, 3), np.uint8), rng.integers(0, 256, (9, 4, 3), np.uint8)]

    def build(mod):
        b = mod.scene.SceneBuilder()
        for i, im in enumerate(imgs):
            b.add(b.sphere((3 * i, 0, 0), 1.0, b.lambertian(b.image_texture(im))))
        return b

    cj = _jax_compile(lambda: build(zj).compile(), budget).compiled
    ct = build(zt).compile(device="cpu", texture_lut=budget).compiled
    return cj, ct


@pytest.mark.parametrize("budget", [NATIVE, 20])
def test_lut_fetch_bitwise(budget):
    cj, ct = _two_image_lut_scenes(budget)
    assert ct.tex_lut_dims == cj.tex_lut_dims
    img, u, v = _uv_cases()
    flat_j = np.asarray(jtex.lut_flat_index(cj.tex_lut_dims, jnp.asarray(img), jnp.asarray(u),
                                            jnp.asarray(v)))
    flat_t = ttex.lut_flat_index(ct.tex_lut_dims, torch.from_numpy(img), torch.from_numpy(u),
                                 torch.from_numpy(v))
    np.testing.assert_array_equal(flat_t.numpy(), flat_j)
    rgb_j = jtex.lut_lookup(cj, jnp.asarray(img), jnp.asarray(u), jnp.asarray(v))
    rgb_t = ttex.lut_lookup(ct, torch.from_numpy(img), torch.from_numpy(u), torch.from_numpy(v))
    for a, b in zip(rgb_t, rgb_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if budget == NATIVE:  # the LUT holds the atlas's texels
        atlas = ttex.atlas_lookup(ct, torch.from_numpy(img), torch.from_numpy(u),
                                  torch.from_numpy(v))
        for a, b in zip(rgb_t, atlas):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


# ---- 3. compiled tables ----

@pytest.mark.parametrize("budget", [NATIVE, 8])
def test_lut_scene_tables_equal_jax(budget):
    sj = _jax_compile(lambda: _image_scene(zj).compile(), budget)
    st = _image_scene(zt).compile(device="cpu", texture_lut=budget)
    cj, ct = sj.compiled, st.compiled
    _assert_same(ct, cj)
    assert ct.tex_lut_dims == cj.tex_lut_dims and ct.tex_lut_tab.dtype == torch.int32
    np.testing.assert_array_equal(ct.tex_lut_tab.numpy(), np.asarray(cj.tex_lut_tab).reshape(-1))
    # carried across from the JAX scene's tables
    fields = {f: np.asarray(getattr(cj, f)) for f in ARRAY_FIELDS}
    fields["tex_lut_tab"] = np.asarray(cj.tex_lut_tab)
    carried = compiled_from_arrays(fields, {f: getattr(cj, f) for f in STATIC_FIELDS}, "cpu")
    _assert_same(carried, cj)
    np.testing.assert_array_equal(carried.tex_lut_tab.numpy(), ct.tex_lut_tab.numpy())
    # the budget also comes from the environment, as in the JAX package
    os.environ["ZWRT_TEX_LUT"] = str(budget)
    try:
        env = _image_scene(zt).compile(device="cpu").compiled
    finally:
        del os.environ["ZWRT_TEX_LUT"]
    assert env.tex_lut_dims == ct.tex_lut_dims
    assert _image_scene(zt).compile(device="cpu", texture_lut=0).compiled.tex_lut_tab is None


# ---- 4. routing ----

@pytest.mark.parametrize("kind,budget,fused", [
    ("plain", 0, True), ("image", 0, False), ("image", NATIVE, True),
    ("emitter", 0, False), ("emitter", NATIVE, True),
])
def test_routing_matches_jax(kind, budget, fused):
    """The whole-render kernel takes scenes without images and image scenes
    with a LUT, as in JAX; the bounce kernel takes every scene the port
    compiles, image emitters without a LUT included (JAX's needs one)."""
    def build(mod):
        if kind == "image":
            return _image_scene(mod)
        if kind == "emitter":
            return _emitter_scene(mod)
        b = mod.scene.SceneBuilder()
        b.add(b.sphere((0, 0, 0), 1.0, b.lambertian(b.solid_color((0.5, 0.5, 0.5)))))
        return b

    cj = _jax_compile(lambda: build(zj).compile(), budget).compiled
    ct = build(zt).compile(device="cpu", texture_lut=budget).compiled
    assert ct.has_emissive_image == cj.has_emissive_image == (kind == "emitter")
    assert tbounce.supports_fused_render(ct) == jpb.supports_fused_render(cj) == fused
    assert tbounce.supports_bounce_kernel(ct)
    assert jpb.supports_bounce_kernel(cj) == (kind != "emitter" or budget > 0)


def test_nested_checker_is_refused():
    """A checker of checkers with a LUT: the JAX package renders it on XLA
    only, and so does the port, on the fixed-depth path; it compiles to
    JAX's tables, LUT included, and carries across (the name is the test's
    from when the port refused it)."""
    def build(mod):
        b = mod.scene.SceneBuilder()
        solid = b.solid_color((0.5, 0.5, 0.5))
        tex = b.checkerboard(1.0, b.checkerboard(1.0, solid, b.image_texture(_checker_img())), solid)
        b.add(b.sphere((0, 0, 0), 1.0, b.lambertian(tex)))
        return b

    cj = _jax_compile(lambda: build(zj).compile(), NATIVE).compiled
    assert cj.has_nested_checker and not jpb.supports_bounce_kernel(cj)
    ct = build(zt).compile(device="cpu", texture_lut=NATIVE).compiled
    fields = {f: np.asarray(getattr(cj, f)) for f in ARRAY_FIELDS}
    fields["tex_lut_tab"] = np.asarray(cj.tex_lut_tab)
    static = {f: getattr(cj, f) for f in STATIC_FIELDS + ("has_nested_checker",)}
    carried = compiled_from_arrays(fields, static, "cpu")
    for cs in (ct, carried):
        assert cs.has_nested_checker and cs.tex_lut_dims == cj.tex_lut_dims
        assert not tbounce.supports_bounce_kernel(cs) and not tbounce.supports_fused_render(cs)
        np.testing.assert_array_equal(cs.tex_lut_tab.numpy(), np.asarray(cj.tex_lut_tab).reshape(-1))
        np.testing.assert_array_equal(cs.shade_rows.numpy(), np.asarray(cj.shade_rows))


@pytest.mark.parametrize("budget", [NATIVE, 8, 0])
def test_image_args_pack_the_fetched_table(budget):
    """The kernels' image table (``ops/fused_render.py:image_args``, packed
    on the host) is the LUT when the scene has one, else the atlas, each
    image at the base and row stride of the plain fetch."""
    cs = _image_scene(zt).compile(device="cpu", texture_lut=budget).compiled
    dims, texels = tfused.image_args(cs)
    if budget:
        (w, h, base), = cs.tex_lut_dims
        want, table = [[w, h, base, w]], cs.tex_lut_tab
    else:
        (w, h), = cs.image_dims
        want, table = [[w, h, 0, cs.atlas_packed.shape[2]]], cs.atlas_packed.reshape(-1)
    assert dims.dtype == torch.int32 and dims.tolist() == want
    assert torch.equal(texels, table)


# ---- 5. renders through the whole-render path ----

@pytest.mark.parametrize("budget", [NATIVE, 8])
def test_lut_render_matches_jax_kernel(pallas_interpret, budget):
    sj = _jax_compile(lambda: _image_scene(zj).compile(), budget)
    st = _image_scene(zt).compile(device="cpu", texture_lut=budget)
    calls, passes = integrator.render_fused_reference.calls, integrator.trace_paths_regen.passes
    fb_t = _port_render(st, 16, 4, 5)
    # the whole-render path, not the bounce kernel's driver loop
    assert integrator.render_fused_reference.calls == calls + 1
    assert integrator.trace_paths_regen.passes == passes
    fb_j = np.asarray(zj.render.Renderer(samples_per_pixel=4, max_ray_bounce_depth=5,
                                         seed=0).render(sj, 16, 16))
    assert np.isfinite(fb_t).all() and fb_t.mean() > 0
    np.testing.assert_allclose(fb_t, fb_j, rtol=RTOL, atol=ATOL)
    if budget == NATIVE:  # identical texels: the atlas render, bitwise
        fb_atlas = _port_render(_image_scene(zt).compile(device="cpu"), 16, 4, 5)
        np.testing.assert_array_equal(fb_t, fb_atlas)


def test_lut_render_checker_of_image():
    """A checker with an image child resolves the parity-selected image
    through the LUT too (the record's second image column), bitwise equal
    to the port's atlas render and to JAX's XLA integrator run eagerly.

    Not against a jitted JAX render: the image quad lies in the plane
    z = -2, a lattice plane of the 0.5 checker, so a hit's parity turns on
    the last bit of its z.  XLA contracts o + t * d into an FMA under jit
    and flips it on about a quarter of the pixels; eager JAX, the port and
    the card's kernels (built with -fmad=false) round each step."""
    sj = _image_scene(zj, nested_checker_child=True).compile()
    st = _image_scene(zt, nested_checker_child=True).compile(device="cpu", texture_lut=NATIVE)
    calls = integrator.render_fused_reference.calls
    fb_t = _port_render(st, 12, 4, 4)
    assert integrator.render_fused_reference.calls == calls + 1
    fb_atlas = _port_render(_image_scene(zt, nested_checker_child=True).compile(device="cpu"),
                            12, 4, 4)
    np.testing.assert_array_equal(fb_t, fb_atlas)
    with jax.disable_jit():
        fb_j = _jax_render(sj, 12, 4, 4, pallas=False)
    assert np.isfinite(fb_t).all() and fb_t.mean() > 0
    np.testing.assert_allclose(fb_t, fb_j, rtol=XLA_RTOL, atol=XLA_ATOL)


def test_lut_render_tree_scene(pallas_interpret):
    sj = _jax_compile(lambda: _tree_scene(zj).compile(), NATIVE)
    st = _tree_scene(zt).compile(device="cpu", texture_lut=NATIVE)
    assert st.compiled.has_sph_tree and st.compiled.tex_lut_dims
    fb_t = _port_render(st, 12, 2, 4)
    fb_j = np.asarray(zj.render.Renderer(samples_per_pixel=2, max_ray_bounce_depth=4,
                                         seed=0).render(sj, 12, 12))
    np.testing.assert_allclose(fb_t, fb_j, rtol=RTOL, atol=ATOL)


# ---- 6. image emitters ----

@pytest.mark.parametrize("budget", [NATIVE, 0])
def test_image_emitter_matches_jax_xla(budget):
    """With a LUT the emitter scene takes the whole-render path, without
    one the bounce kernel's regenerating mode; both equal JAX's XLA
    integrator, which reads the atlas (identical texels at this budget)."""
    sj = _jax_compile(lambda: _emitter_scene(zj).compile(), NATIVE)
    st = _emitter_scene(zt).compile(device="cpu", texture_lut=budget)
    fused, regen = integrator.render_fused_reference.calls, integrator.bounce_regen_reference.calls
    fb_t = _port_render(st, 12, 4, 4)
    assert integrator.render_fused_reference.calls == fused + (1 if budget else 0)
    assert integrator.bounce_regen_reference.calls > regen if not budget else True
    fb_j = _jax_render(sj, 12, 4, 4, pallas=False)
    assert float(fb_t.max()) > 0.05  # the lamp is visible
    np.testing.assert_allclose(fb_t, fb_j, rtol=XLA_RTOL, atol=XLA_ATOL)


# ---- 7. earth under the sphere-UV allowance ----

def test_earth_lut_matches_jax_kernel(pallas_interpret):
    sj = _jax_compile(lambda: zj.models.load_scene("earth"), 8192)
    st = zt.models.load_scene("earth", device="cpu", texture_lut=8192)
    assert st.compiled.tex_lut_dims == sj.compiled.tex_lut_dims == ((128, 64, 0),)
    fb_t = _port_render(st, 16, 2, 3)
    fb_j = np.asarray(zj.render.Renderer(samples_per_pixel=2, max_ray_bounce_depth=3,
                                         seed=0).render(sj, 16, 16))
    assert np.isfinite(fb_t).all()
    bad = ~np.isclose(fb_t, fb_j, rtol=RTOL, atol=ATOL).all(-1)
    assert bad.mean() <= 0.02, bad.sum()  # isolated texel-boundary pixels
    assert np.abs(fb_t - fb_j).max() < 0.1  # a texel step, not a divergent path
    np.testing.assert_allclose(fb_t.mean(), fb_j.mean(), rtol=1e-3)
