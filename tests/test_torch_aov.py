"""The first-hit AOV pass of the port (``render/aov.py``) on the CPU,
against the JAX package's ``render/aov.py``.

  1. ``render_aovs`` at 16x16, 4 spp on cornell_box (brute), balls (sphere
     tree, depth of field), a dielectric scene and earth (image texture):
     coverage equal, and albedo, normal and depth within rtol 1e-5 / atol
     1e-6 on >= 99.9% of pixels, against the JAX pass run eagerly
     (``jax.disable_jit``: each operation rounds on its own, as the port's
     do).
  2. The jitted JAX pass contracts multiply-adds (ROADMAP Queue 3,
     "Settled"): the witness holds that every pixel where the port and the
     jitted pass differ is one where the jitted and the eager JAX passes
     differ the same way, and names cornell's edge pixels (camera rays
     along the floor / red-wall edge that hit in the port and in eager JAX
     and miss under jit).
  3. The properties of the JAX package's tests/test_aov.py: a head-on wall
     is exact, dielectrics read white, misses read the background and
     zeroes, cornell's walls land in the albedo, ``write_aovs`` writes three
     PNGs; and the pass over several row bands equals the pass in one.
  4. On CPU tensors the trace is the closest hit's plain version (nothing
     launches); the kernel's entry points refuse CPU rays.
"""

import jax
import numpy as np
import pytest
import torch

from test_torch_reference_native import reference_decodes_with_stb  # noqa: F401
import zig_weekend_raytracer_tpu as zj
import zig_weekend_raytracer_tpu_torch as zt
from zig_weekend_raytracer_tpu.render.aov import render_aovs as j_render_aovs
from zig_weekend_raytracer_tpu_torch.ops import closest_hit as ch
from zig_weekend_raytracer_tpu_torch.ops import trace as ttrace
from zig_weekend_raytracer_tpu_torch.render.aov import render_aovs, write_aovs

RTOL, ATOL, AGREE = 1e-5, 1e-6, 0.999
W = H = 16
SPP = 4
# cornell 16x16@4: rays along the floor / red-wall edge that the jitted JAX
# pass misses (its contracted o + d t falls outside both quads)
CORNELL_EDGE_PIXELS = [(12, 12), (13, 13), (14, 14)]


def _glass_scene(pkg, **compile_kw):
    """A glass sphere and a metal sphere over a diffuse floor."""
    b = pkg.scene.SceneBuilder()
    b.add(b.quad((-4, -1, -4), (8, 0, 0), (0, 0, 8), b.lambertian(b.solid_color((0.4, 0.6, 0.3)))))
    b.add(b.sphere((-0.6, 0.0, 0.0), 0.9, b.dielectric(1.5)))
    b.add(b.sphere((1.2, -0.2, -0.5), 0.7, b.metal((0.8, 0.7, 0.6), 0.1)))
    b.set_background((0.3, 0.4, 0.9))
    b.set_camera(pkg.scene.Camera(look_from=(0, 1, 5), look_at=(0, 0, 0)))
    return b.compile(**compile_kw)


def _scenes(name):
    if name == "glass":
        return _glass_scene(zj), _glass_scene(zt, device="cpu")
    return zj.models.load_scene(name), zt.models.load_scene(name, device="cpu")


def _port(scene, w=W, h=H, spp=SPP, **kw):
    aovs = render_aovs(scene, w, h, spp=spp, **kw)
    for k, v in aovs.items():
        assert v.dtype == torch.float32 and v.device.type == "cpu", k
    return {k: v.numpy() for k, v in aovs.items()}


def _eager_jax(scene, **kw):
    with jax.disable_jit():
        return j_render_aovs(scene, W, H, spp=SPP, **kw)


def _close(a, b):
    """Pixels within the tolerance, per pixel over channels."""
    ok = np.isclose(a, b, rtol=RTOL, atol=ATOL)
    return ok.all(-1) if ok.ndim == 3 else ok


@pytest.mark.parametrize("name", ["cornell_box", "balls", "glass", "earth"])
def test_aovs_match_eager_jax(name):
    sj, st = _scenes(name)
    want = _eager_jax(sj)
    got = _port(st)
    np.testing.assert_array_equal(got["coverage"], want["coverage"])
    assert got["coverage"].max() > 0
    for key in ("albedo", "normal", "depth"):
        assert got[key].shape == want[key].shape
        assert _close(got[key], want[key]).mean() >= AGREE, key


@pytest.mark.parametrize("name", ["cornell_box", "balls"])
def test_jit_differences_are_xla_contraction_witness(name):
    sj, st = _scenes(name)
    eager = _eager_jax(sj)
    jit = j_render_aovs(sj, W, H, spp=SPP)
    got = _port(st)
    for key in ("coverage", "albedo", "normal", "depth"):
        port_vs_jit = ~_close(got[key], jit[key])
        eager_vs_jit = ~_close(eager[key], jit[key])
        np.testing.assert_array_equal(port_vs_jit, eager_vs_jit, err_msg=key)
        assert _close(got[key], eager[key]).all(), key
    cov = np.argwhere(got["coverage"] != jit["coverage"]).tolist()
    if name == "cornell_box":
        assert [tuple(p) for p in cov] == CORNELL_EDGE_PIXELS
        assert all(got["coverage"][p] > jit["coverage"][p] for p in CORNELL_EDGE_PIXELS)
    else:
        assert cov == []


def _wall_scene(color=(0.2, 0.5, 0.8)):
    b = zt.scene.SceneBuilder()
    mat = b.lambertian(b.solid_color(color))
    b.add(b.quad((-50, -50, -1), (100, 0, 0), (0, 100, 0), mat))
    b.set_background((0, 0, 0))
    b.set_camera(zt.scene.Camera(look_from=(0, 0, 5), look_at=(0, 0, 0)))
    return b.compile(device="cpu")


def test_wall_albedo_normal_depth_exact():
    a = _port(_wall_scene(), 8, 8, 2)
    assert a["coverage"].min() == 1.0
    np.testing.assert_allclose(a["albedo"][..., 0], 0.2, atol=1e-6)
    np.testing.assert_allclose(a["albedo"][..., 1], 0.5, atol=1e-6)
    np.testing.assert_allclose(a["albedo"][..., 2], 0.8, atol=1e-6)
    # the quad's normal u x v = +z faces the camera
    np.testing.assert_allclose(a["normal"][..., 2], 1.0, atol=1e-6)
    np.testing.assert_allclose(a["normal"][..., :2], 0.0, atol=1e-6)
    # camera rays are unnormalized (the viewport at focus distance 10), so
    # the wall at distance 6 reads t = 0.6 in every pixel
    np.testing.assert_allclose(a["depth"], 0.6, atol=1e-3)


def test_dielectric_albedo_is_white():
    b = zt.scene.SceneBuilder()
    b.add(b.sphere((0, 0, 0), 2.0, b.dielectric(1.5)))
    b.set_background((0.1, 0.1, 0.1))
    b.set_camera(zt.scene.Camera(look_from=(0, 0, 5), look_at=(0, 0, 0)))
    a = _port(b.compile(device="cpu"), 9, 9, 2)
    assert a["coverage"][4, 4] == 1.0
    np.testing.assert_allclose(a["albedo"][4, 4], 1.0, atol=1e-6)


def test_miss_reads_background_and_zeroes():
    b = zt.scene.SceneBuilder()
    b.set_background((0.25, 0.5, 0.75))
    b.set_camera(zt.scene.Camera(look_from=(0, 0, 5), look_at=(0, 0, 0)))
    a = _port(b.compile(device="cpu"), 6, 6, 2)
    assert a["coverage"].max() == 0.0
    np.testing.assert_allclose(a["albedo"][..., 0], 0.25, atol=1e-6)
    np.testing.assert_allclose(a["albedo"][..., 2], 0.75, atol=1e-6)
    np.testing.assert_array_equal(a["normal"], 0.0)
    np.testing.assert_array_equal(a["depth"], 0.0)


def test_cornell_walls_in_albedo():
    a = _port(zt.models.load_scene("cornell_box", device="cpu"), 16, 16, 2)
    left, right = a["albedo"][:, :3], a["albedo"][:, -3:]
    assert left[..., 1].mean() > left[..., 0].mean()    # green wall
    assert right[..., 0].mean() > right[..., 1].mean()  # red wall
    assert np.isfinite(a["depth"]).all()
    assert (a["depth"][a["coverage"] == 1.0] > 0).all()


def test_write_aovs_pngs(tmp_path):
    from PIL import Image

    a = render_aovs(_wall_scene(), 8, 8, spp=1)
    paths = write_aovs(str(tmp_path / "out.ppm"), a)
    assert [p.rsplit(".", 2)[1] for p in paths] == ["albedo", "normal", "depth"]
    for p in paths:
        assert np.asarray(Image.open(p)).shape[:2] == (8, 8)


def test_bands_equal_one_pass():
    """Row bands of 3 rows (max_rays_per_chunk) give the single band's
    buffers bitwise, through one closest hit per band."""
    scene = zt.models.load_scene("balls", device="cpu")
    calls = ttrace.closest_hit.calls
    one = _port(scene, 8, 8, 2)
    assert ttrace.closest_hit.calls == calls + 1
    banded = _port(scene, 8, 8, 2, max_rays_per_chunk=8 * 2 * 3)
    assert ttrace.closest_hit.calls == calls + 1 + 3
    for key in one:
        np.testing.assert_array_equal(banded[key], one[key], err_msg=key)


def test_cpu_pass_launches_no_kernel():
    launches = ch.closest_hit.launches
    _port(zt.models.load_scene("cornell_box", device="cpu"), 4, 4, 1)
    assert ch.closest_hit.launches == launches


def test_kernel_entry_points_refuse_cpu_rays():
    scene = zt.models.load_scene("cornell_box", device="cpu")
    v = lambda: zt.math.v3.V3(*(torch.zeros(4) for _ in range(3)))
    launches = ch.closest_hit.launches
    with pytest.raises(ValueError, match="cuda"):
        ch.launch_args(scene.compiled, v(), v(), torch.zeros(4), 1e-3)
    assert ch.closest_hit.launches == launches


def test_hit_and_aov_bounds_count_the_pass():
    """The closest-hit kernel's bound on the AOV rays (utils/roofline.py):
    operations from the plain cond walk's counts, bytes from the rays and
    tables; the AOV pass's bound adds the camera rays, the per-hit tail and
    the buffers, so it is the larger."""
    from zig_weekend_raytracer_tpu_torch.render import aov
    from zig_weekend_raytracer_tpu_torch.render.camera import camera_params
    from zig_weekend_raytracer_tpu_torch.utils import roofline, workcount

    scene = zt.models.load_scene("cornell_box", device="cpu")
    cs = scene.compiled
    rays = aov.band_rays(scene, camera_params(scene.camera, 8, 8), 0, 0, width=8, height=8,
                         band_rows=8, spp=2, sampler=zt.sampling.SamplerKind.SOBOL,
                         has_dof=False)
    n = rays[2].numel()
    with workcount.counting() as c:
        hit = ttrace.closest_hit(cs, *rays, zt.dtypes.T_MIN, walk="cond")
    assert c["trace"] == n == 8 * 8 * 2
    assert c["sphere_test"] == n * cs.n_spheres and c["quad_test"] == n * cs.n_quads
    assert roofline.hit_bytes(cs, n) == n * 40 + roofline.trace_bytes(cs)
    ms, by = roofline.hit_bound_ms(c, cs, n)
    assert by == "operations"
    assert ms == pytest.approx(roofline.ops_seconds(roofline.trace_ops(c)) * 1e3)
    hits = int((hit.kind >= 0).sum())
    aov_ms, _ = roofline.aov_bound_ms(c, cs, n, hits, int((hit.kind == 0).sum()), 64, False)
    assert aov_ms > ms > 0
