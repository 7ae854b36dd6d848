"""Renders through each tree walk of the PyTorch port against the JAX
package's kernel with the same walk, in interpret mode, on the CPU.

  1. ``render_fused`` on balls at leaf span 2 (a 61-node sphere tree), 12x12,
     2 spp, depth 3, with ``ZWRT_TRAV`` = cond, queue, rowqueue and spec on
     both sides: work counts equal and radiance within rtol 1e-6 / atol
     1e-7, the bar tests/test_pallas.py:335 holds the JAX walks to.
  2. ``Renderer.render`` of tests/test_pallas.py:241's scene (70 spheres and
     70 quads, leaf span 4) under ``ZWRT_UNI_TREE=1`` against JAX's
     ``Renderer`` walking its unified tree in the kernel, within rtol 1e-6 /
     atol 1e-7 on every pixel but one, and against the port's own per-kind
     render on every pixel, as the JAX test holds its unified walk to its
     per-kind walks.  The one pixel, (row 8, column 0), differs between the
     port and JAX in the per-kind renders too: its first diffuse bounce
     leaves the sphere it hit at a grazing angle from a point a rounding
     error inside it, and exits again after 0.00165 (the port, in float64
     from its float32 state: just past T_MIN = 0.001, a hit) where JAX's
     XLA-compiled arithmetic puts the exit below T_MIN (ROADMAP Queue 3).

``ZWRT_TRAV`` is read when JAX traces the kernel and is not in the jit key,
so every JAX render here starts from ``jax.clear_caches()``, and the
environment is restored by ``monkeypatch``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zig_weekend_raytracer_tpu as zj
import zig_weekend_raytracer_tpu_torch as zt
from test_torch_balls import _lanes, _render_port
from zig_weekend_raytracer_tpu.ops import pallas_bounce
from zig_weekend_raytracer_tpu.render import camera as jcam
from zig_weekend_raytracer_tpu.sampling.sampler import SamplerKind as JKind
from zig_weekend_raytracer_tpu_torch.ops import fused_render
from zig_weekend_raytracer_tpu_torch.render import integrator

RTOL, ATOL = 1e-6, 1e-7
W = H = 12


@pytest.fixture()
def fresh_jit():
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.mark.parametrize("trav", ["cond", "queue", "rowqueue", "spec"])
def test_render_with_each_walk_matches_jax_kernel(pallas_interpret, fresh_jit, monkeypatch, trav):
    monkeypatch.setenv("ZWRT_LEAF_GROUPS", "2")
    monkeypatch.setenv("ZWRT_TRAV", trav)
    sj, st = zj.models.load_scene("balls"), zt.models.load_scene("balls", device="cpu")
    assert st.compiled.sph_tree_box.shape[0] == 61
    lanes = _lanes()
    px, py, s0, s1, stride = lanes
    rad_j, work_j = pallas_bounce.render_fused(
        sj.compiled, *(jnp.asarray(a) for a in (px, py, s0, s1)), jnp.uint32(0),
        np.float32(1e-3), camera_consts=jcam.camera_consts(sj.camera, W, H),
        sampler=JKind.SOBOL, width=W, height=H, spp=2, stride=stride,
        max_depth=3, has_dof=True, want_work=True,
    )
    with_walk = fused_render.walk_of(st.compiled)
    rt, wt = _render_port(st, lanes)
    assert with_walk == trav
    np.testing.assert_array_equal(wt, np.asarray(work_j))
    np.testing.assert_allclose(rt, np.stack([np.asarray(c) for c in rad_j], 1),
                               rtol=RTOL, atol=ATOL)


def _uni_scene(mod):
    """tests/test_pallas.py:241's scene."""
    rng = np.random.default_rng(11)
    b = mod.scene.SceneBuilder()
    mat = b.lambertian(b.solid_color((0.5, 0.5, 0.5)))
    for _ in range(70):
        b.add(b.sphere(rng.uniform(-10, 10, 3), rng.uniform(0.2, 1.5), mat))
    for _ in range(70):
        b.add(b.quad(rng.uniform(-10, 10, 3), rng.uniform(-2, 2, 3), rng.uniform(-2, 2, 3), mat))
    b.use_bvh(True, min_prims=2)
    b.set_camera(mod.scene.Camera(look_from=(0, 0, 30), look_at=(0, 0, 0)))
    b.set_background((0.6, 0.7, 0.9))
    return b.compile(**({"device": "cpu"} if mod is zt else {}))


def _differing_pixels(a, b):
    return {tuple(int(v) for v in p)
            for p in np.argwhere(~np.isclose(a, b, rtol=RTOL, atol=ATOL).all(-1))}


def test_uni_tree_render_matches_jax_kernel(pallas_interpret, fresh_jit, monkeypatch):
    render = lambda mod, scene: np.asarray(mod.render.Renderer(
        samples_per_pixel=1, max_ray_bounce_depth=3, seed=0).render(scene, W, H))
    monkeypatch.setenv("ZWRT_LEAF_GROUPS", "4")
    monkeypatch.setenv("ZWRT_UNI_TREE", "1")
    sj, st = _uni_scene(zj), _uni_scene(zt)
    assert sj.compiled.has_uni_tree and st.compiled.has_uni_tree
    assert st.compiled.uni_tree_box.shape[0] > 3
    fb_j = render(zj, sj)
    jax.clear_caches()
    calls = integrator.render_fused_reference.calls
    with_walk = fused_render.walk_of(st.compiled)
    fb_t = render(zt, st)
    assert with_walk == "uni" and integrator.render_fused_reference.calls > calls
    assert np.isfinite(fb_t).all()
    monkeypatch.delenv("ZWRT_UNI_TREE")
    kj, kt = _uni_scene(zj), _uni_scene(zt)
    assert not kt.compiled.has_uni_tree
    fb_kj, fb_kt = render(zj, kj), render(zt, kt)
    assert _differing_pixels(fb_t, fb_kt) == set()
    assert _differing_pixels(fb_t, fb_j) == _differing_pixels(fb_kt, fb_kj) == {(8, 0)}
    np.testing.assert_allclose(np.delete(fb_t.reshape(-1, 3), 8 * W, 0),
                               np.delete(fb_j.reshape(-1, 3), 8 * W, 0), rtol=RTOL, atol=ATOL)


def test_grazing_lane_exits_past_t_min():
    """The witness for the pixel exempted above: the port's first bounce at
    (row 8, column 0) scatters from sphere 5 into a ray that, evaluated in
    float64 from the port's float32 origin and direction, leaves the same
    sphere again after 0.00165, just past T_MIN (a grazing exit from a point
    a rounding error inside it), so the port's second hit is what exact
    arithmetic gives for its state."""
    from zig_weekend_raytracer_tpu_torch.math.v3 import V3
    from zig_weekend_raytracer_tpu_torch.ops import trace as ttrace
    from zig_weekend_raytracer_tpu_torch.render import camera as tcam

    st = _uni_scene(zt)
    cs = st.compiled
    px, py, s = torch.tensor([0]), torch.tensor([8]), torch.tensor([0])
    rid = (s * H + py) * W + px
    cam = tcam.camera_params_from_consts(tcam.camera_consts(st.camera, W, H))
    o, d, tm = tcam.generate_rays(cam, False, zt.sampling.SamplerKind.SOBOL, 0, rid, px, py, s,
                                  1, W, H)
    one = V3.full((1,), 1.0, 1.0, 1.0, "cpu")
    o1, d1, _, _, alive = integrator.bounce(
        cs, 0, zt.dtypes.T_MIN, torch.zeros(1, dtype=torch.int64), o, d, tm,
        rid.to(torch.int64), one, V3.zeros((1,), "cpu"), torch.ones(1, dtype=torch.bool))
    hit = ttrace.closest_hit(cs, o1, d1, tm, zt.dtypes.T_MIN)
    assert bool(alive) and (int(hit.kind), int(hit.idx)) == (0, 5)
    f64 = lambda v: np.array([float(c) for c in v], np.float64)
    origin, direction = f64(o1), f64(d1)
    oc = np.array([float(c[5]) for c in cs.sph_center]) - origin
    r = float(cs.sph_radius[5])
    a, h = direction @ direction, direction @ oc
    disc = h * h - a * (oc @ oc - r * r)
    near, far = (h - np.sqrt(disc)) / a, (h + np.sqrt(disc)) / a
    assert near < 0 < zt.dtypes.T_MIN < far < 2 * zt.dtypes.T_MIN  # inside, grazing exit
    np.testing.assert_allclose(float(hit.t), far, rtol=1e-3)
