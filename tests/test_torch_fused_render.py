"""The fused render kernel's module: ``render_fused`` of the PyTorch port
on CPU tensors (its plain version) against the JAX package's
``pallas_bounce.render_fused``, whose Pallas kernel runs in interpret mode,
on the lane layout of JAX's ``_render_band_regen``.

Tolerance.  Per-lane work counts are equal exactly, and radiance agrees
within rtol=1e-5, atol=1e-6, on every lane but the four EDGE_LANES of
cornell 16x16 at 2 spp.  Their camera rays run exactly along the edge the
floor shares with the red wall, where the port finds a hit and XLA on the
CPU, which fuses the interior test's multiply-adds, finds a miss;
test_edge_rays_round_across_the_floor_wall_edge shows which side rounds
across the edge.

The CUDA kernel itself is held against the same plain version on the card
by chip_smoke.py; here, without a GPU, its entry points must refuse rather
than fall back."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zig_weekend_raytracer_tpu as zj
import zig_weekend_raytracer_tpu_torch as zt
from zig_weekend_raytracer_tpu.geometry import quad as jquad
from zig_weekend_raytracer_tpu.math.v3 import V3 as JV3
from zig_weekend_raytracer_tpu.ops import pallas_bounce
from zig_weekend_raytracer_tpu.render import camera as jcam
from zig_weekend_raytracer_tpu.render import renderer as jr
from zig_weekend_raytracer_tpu.sampling.sampler import SamplerKind as JKind
from zig_weekend_raytracer_tpu_torch.geometry import quad as tquad
from zig_weekend_raytracer_tpu_torch.math.v3 import V3
from zig_weekend_raytracer_tpu_torch.ops import _build
from zig_weekend_raytracer_tpu_torch.ops import fused_render
from zig_weekend_raytracer_tpu_torch.render import camera as tcam
from zig_weekend_raytracer_tpu_torch.render import integrator

RTOL, ATOL = 1e-5, 1e-6
# (px, py, first sample) of the lanes of cornell 16x16 at 2 spp whose
# camera ray meets the floor/red-wall edge exactly; the quads' rows
EDGE_LANES = ((12, 12, 0), (13, 13, 0), (13, 13, 1), (14, 14, 1))
FLOOR, RED_WALL = 0, 1


def _jax_regen_lanes(scene_j, width, height, spp):
    """px, py, s0, s1 and the stride of JAX's _render_band_regen layout
    (one band, padded to the scene's block with dead lanes)."""
    s_par, band_rows = zj.render.Renderer().regen_geometry(width, height, spp)
    assert band_rows == height
    tile = jr.pick_tile(width, band_rows)
    px, py, sidx, _ = (np.asarray(a) for a in jr.ray_grid(width, height, 0, band_rows, 0, s_par, tile))
    n = px.shape[0]
    blk = scene_j.compiled.rows * 128
    n_pad = -(-n // blk) * blk
    pad = lambda a, fill: np.concatenate([a, np.full(n_pad - n, fill, np.int32)]).astype(np.int32)
    return pad(px, 0), pad(py, 0), pad(sidx, 0), pad(np.full(n, spp), 0), s_par


def _compare(scene_pair, width, height, spp, depth, edge_lanes=()):
    sj, st = scene_pair
    px, py, s0, s1, stride = _jax_regen_lanes(sj, width, height, spp)
    rad_j, work_j = pallas_bounce.render_fused(
        sj.compiled, *(jnp.asarray(a) for a in (px, py, s0, s1)), jnp.uint32(0),
        np.float32(1e-3), camera_consts=jcam.camera_consts(sj.camera, width, height),
        sampler=JKind.SOBOL, width=width, height=height, spp=spp, stride=stride,
        max_depth=depth, has_dof=False, want_work=True,
    )
    calls = integrator.render_fused_reference.calls
    launches = dict(fused_render.render_fused.launches)
    rad_t, work_t = fused_render.render_fused(
        st.compiled, *(torch.from_numpy(a) for a in (px, py, s0, s1)), 0,
        zt.dtypes.T_MIN, camera_consts=tcam.camera_consts(st.camera, width, height),
        sampler=zt.sampling.SamplerKind.SOBOL, width=width, height=height, spp=spp,
        stride=stride, max_depth=depth, has_dof=False, want_work=True,
    )
    # CPU tensors take the plain version and launch nothing
    assert integrator.render_fused_reference.calls == calls + 1
    assert fused_render.render_fused.launches == launches
    assert work_t.dtype == torch.int32
    rj = np.stack([np.asarray(c) for c in rad_j], 1)
    rt = rad_t.to_array().numpy()
    wj, wt = np.asarray(work_j), work_t.numpy()
    assert np.isfinite(rt).all()

    edge = np.zeros(px.shape, bool)
    for x, y, s in edge_lanes:
        edge |= (px == x) & (py == y) & (s0 == s) & (s1 > s0)
    assert edge.sum() == len(edge_lanes)
    np.testing.assert_array_equal(wt[~edge], wj[~edge])
    np.testing.assert_allclose(rt[~edge], rj[~edge], rtol=RTOL, atol=ATOL)
    return wt


@pytest.fixture(scope="module")
def cornell():
    return zj.models.load_scene("cornell_box"), zt.models.load_scene("cornell_box", device="cpu")


def test_render_fused_matches_jax_kernel(pallas_interpret, cornell):
    """cornell 16x16, 2 spp, depth 3, with work counts."""
    work = _compare(cornell, 16, 16, 2, 3, EDGE_LANES)
    assert work[: 16 * 16 * 2].min() >= 1


def test_edge_rays_round_across_the_floor_wall_edge(cornell):
    """Witness for EDGE_LANES.  Each camera ray has dx == dy, so it lies in
    the box's x = y symmetry plane and meets the floor (y = 0) and the red
    wall (x = 0) at the same t, on their shared edge.  There the interior
    coordinate alpha across the edge is 0: a hit under the inclusive test.
    float64 (the port's operation order) gives exactly 0, and so does the
    port in float32, where o + d*t rounds d*t to -278 before the add.  A
    fused multiply-add keeps t's rounding error instead, which is negative
    on these rays and puts the point outside both quads.  JAX's hit_t,
    compiled by XLA on the CPU, returns that miss bit for bit."""
    _, st = cornell
    w = h = 16
    px, py, s = (torch.tensor(c) for c in zip(*EDGE_LANES))
    cam = tcam.camera_params(st.camera, w, h)
    o, d, _ = tcam.generate_rays(
        cam, False, zt.sampling.SamplerKind.SOBOL, 0, (s * h + py) * w + px, px, py,
        s, 2, w, h,
    )
    assert torch.equal(d.x, d.y) and torch.equal(o.x, o.y)
    cs = st.compiled
    n = len(EDGE_LANES)
    f64 = lambda v: np.stack([c.numpy().astype(np.float64) for c in v], 1)
    o64, d64 = f64(o), f64(d)
    for q in (FLOOR, RED_WALL):
        tab = {f: [float(c[q]) for c in getattr(cs, f)]
               for f in ("quad_start", "quad_normal", "quad_w", "quad_u", "quad_v")}
        off = float(cs.quad_offset[q])
        rep = lambda f: V3(*(torch.full((n,), c) for c in tab[f]))
        args = [rep(f) for f in tab] + [torch.full((n,), off)]
        t32, a32, _, hit32 = tquad.hit_t(*args, o, d, zt.dtypes.T_MIN, float("inf"))
        assert hit32.all() and (a32 == 0).all()

        s64, n64, wq, u64, v64 = (np.float64(tab[f]) for f in tab)
        t64 = (off - o64 @ n64) / (d64 @ n64)
        a64 = (o64 + d64 * t64[:, None] - s64) @ np.cross(v64, wq)
        assert (a64 == 0).all()

        # fused multiply-add in float32: the float64 product of two
        # float32 values is exact, then one rounding to float32
        t = t32.numpy().astype(np.float64)[:, None]
        planar = (o64 + d64 * t).astype(np.float32) - np.float32(tab["quad_start"])
        cross = np.cross(np.float32(tab["quad_v"]), np.float32(tab["quad_w"]))
        a_fma = (planar.astype(np.float64) @ cross.astype(np.float64)).astype(np.float32)
        assert (a_fma < 0).all()

        jrep = lambda f: JV3(*(jnp.full((n,), c, jnp.float32) for c in tab[f]))
        jo, jd = (JV3(*(jnp.asarray(c.numpy()) for c in v)) for v in (o, d))
        _, a_xla, _, hit_xla = jax.jit(
            lambda o_, d_: jquad.hit_t(
                *(jrep(f) for f in tab), jnp.full((n,), off, jnp.float32), o_, d_,
                np.float32(zt.dtypes.T_MIN), jnp.inf,
            )
        )(jo, jd)
        assert not np.asarray(hit_xla).any()
        np.testing.assert_array_equal(np.asarray(a_xla), a_fma)


def _feature_scene(mod):
    """Checker texture, fuzzy metal, isotropic medium, a moving sphere,
    glass and a quad light: every branch of the kernel's materials."""
    b = mod.scene.SceneBuilder()
    chk = b.checkerboard(0.3, b.solid_color((0.2, 0.3, 0.1)), b.solid_color((0.9, 0.9, 0.9)))
    b.add(b.quad((-5, -1, -5), (10, 0, 0), (0, 0, 10), b.lambertian(chk)))
    b.add(b.sphere((0.1, 0.5, 0), 1.0, b.metal((0.8, 0.6, 0.2), 0.3)))
    b.add(b.moving_sphere((2.1, 0.5, 0), (2.1, 1.0, 0), 0.7,
                          b.isotropic(b.solid_color((0.5, 0.5, 0.9)))))
    b.add(b.sphere((-2.1, 0.5, 0.3), 0.8, b.dielectric(1.5)))
    light = b.add(b.quad((-1, 4, -1), (2, 0, 0), (0, 0, 2),
                         b.diffuse_light(b.solid_color((8, 8, 8)))))
    b.set_lights([light])
    b.set_background((0.3, 0.4, 0.6))
    b.set_camera(mod.scene.Camera(look_from=(0.3, 2, 8), look_at=(0, 0.5, 0)))
    return b.compile(**({"device": "cpu"} if mod is zt else {}))


def test_render_fused_matches_jax_kernel_all_materials(pallas_interpret):
    scenes = (_feature_scene(zj), _feature_scene(zt))
    assert scenes[1].compiled.needs_gauss and scenes[1].compiled.has_moving
    _compare(scenes, 12, 12, 2, 4)


def test_render_fused_counts_work_per_sample(cornell):
    """Each lane's work is at least one pass per sample and at most
    max_depth per sample; dead lanes (s1 <= s0) do nothing."""
    _, st = cornell
    w = h = 8
    spp, depth = 4, 5
    ys, xs = np.divmod(np.arange(2 * w * h) % (w * h), w)
    t = lambda a: torch.from_numpy(np.asarray(a, np.int32))
    s1 = np.where(np.arange(2 * w * h) < w * h, spp, 0)
    rad, work = fused_render.render_fused(
        st.compiled, t(xs), t(ys), t(np.zeros(2 * w * h)), t(s1), 0, zt.dtypes.T_MIN,
        camera_consts=tcam.camera_consts(st.camera, w, h),
        sampler=zt.sampling.SamplerKind.SOBOL, width=w, height=h, spp=spp, stride=1,
        max_depth=depth, has_dof=False, want_work=True,
    )
    work = work.numpy()
    assert (work[: w * h] >= spp).all() and (work[: w * h] <= spp * depth).all()
    assert (work[w * h:] == 0).all()
    assert (rad.to_array().numpy()[w * h:] == 0).all()


def test_cuda_refuses_without_gpu():
    """Without a GPU the CUDA entry points raise; nothing renders on the
    CPU in their place."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py checks the CUDA path")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        zt.render.Renderer(device="cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        zt.models.load_scene("cornell_box", device="cuda")


def test_render_fused_refuses_other_devices(cornell):
    _, st = cornell
    lanes = [torch.zeros(4, dtype=torch.int32, device="meta") for _ in range(4)]
    launches = dict(fused_render.render_fused.launches)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_render.render_fused(
            st.compiled, *lanes, 0, zt.dtypes.T_MIN,
            camera_consts=tcam.camera_consts(st.camera, 2, 2),
            sampler=zt.sampling.SamplerKind.SOBOL, width=2, height=2, spp=1,
            stride=1, max_depth=2, has_dof=False,
        )
    assert fused_render.render_fused.launches == launches


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """A build without a CUDA compiler raises a clear error."""
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this machine has a CUDA toolkit")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_kernel_tables_and_params(cornell):
    """The kernel's scene tables and launch parameters carry the scene:
    sphere r^2, quad A = v x w and B = w x u, lights and camera."""
    _, st = cornell
    cs = st.compiled
    sph, quad = fused_render.kernel_tables(cs)
    assert sph.shape == (1, 8) and quad.shape == (12, 16)
    assert sph.dtype == quad.dtype == torch.float32
    r = float(cs.sph_radius[0])
    assert float(sph[0, 3]) == np.float32(r) * np.float32(r)
    qv = np.stack([c.numpy() for c in cs.quad_v], 1)[:12]
    qw = np.stack([c.numpy() for c in cs.quad_w], 1)[:12]
    np.testing.assert_allclose(quad[:, 6:9].numpy(), np.cross(qv, qw), rtol=1e-6, atol=1e-12)
    cam = tcam.camera_consts(st.camera, 400, 400)
    ints, floats = fused_render.launch_params(
        cs, 0, zt.dtypes.T_MIN, cam, zt.sampling.SamplerKind.SOBOL, 400, 400,
        1024, 1, 10, False,
    )
    assert ints.dtype == np.int32 and floats.dtype == np.float32
    assert list(ints[:15]) == [400, 400, 1024, 1, 10, 2, 9, 32, 0, 1, 12, 13, 2, 0, 0]
    assert len(ints) == 15 + fused_render.MAX_LIGHTS
    assert len(floats) == 23 + fused_render.MAX_LIGHTS * fused_render.LIGHT_FLOATS
    # brute spheres and quads: two row tables, no tree tables
    t_ints, t_ptrs, tables = fused_render.trace_args(cs)
    assert list(t_ints) == [fused_render.TRACE_BRUTE, 1, 0, 0, fused_render.TRACE_BRUTE, 12, 0, 0, 0,
                            0, cs.uni_leaf_span]
    assert t_ptrs.dtype == np.uint64 and list(t_ptrs[[1, 2, 3, 5, 6, 7]]) == [0] * 6
    assert list(t_ptrs[8:]) == [0] * 6  # no unified tree
    assert [tuple(t.shape) for t in tables] == [(1, 8), (12, 16)]
    tab = fused_render.sobol_table(torch.device("cpu"), 9)
    assert tab.shape == (5 * 52,) and tab.dtype == torch.int32
