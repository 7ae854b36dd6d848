"""The tree-scene slice as a whole: balls (485 spheres in a group tree, a
lens with depth of field, fuzzy metal, no lights) in the PyTorch port on
the CPU, against the JAX package.

  1. ``render_fused`` (plain version) against JAX's
     ``pallas_bounce.render_fused`` in interpret mode at 12x12, 2 spp,
     depth 3, has_dof=True: work counts equal and radiance within rtol
     1e-5 / atol 1e-6, the bar of test_torch_fused_render.py.  Both sides
     compile balls at the same forced leaf span: 4 (this suite's default,
     tests/conftest.py) and 2 (a deeper tree).  At the package default
     span, 64, balls is one 512-slot leaf, which the JAX kernel's
     interpreter cannot run in a test's time; there the port's render must
     equal its own render at span 4 lane for lane, since the hits do not
     depend on the tree's shape (the JAX package's own traversal tests
     hold its walks to the same invariance).
  2. ``Renderer.render`` with s_par = 1 against JAX's ``Renderer`` under
     ``pallas_interpret``: both take the coherent driver, their plans'
     (px, py) orders are equal, and the framebuffers agree within rtol
     1e-5 / atol 1e-6.
  3. A scene carried across with ``compiled_from_arrays`` from the JAX
     scene renders exactly as the one the port compiles.

The balls region gates (tests/golden/scene_regions.json at 200x200 and
tests/golden/balls.npz at 64x64, both 32 spp, depth 10) run on the card in
chip_smoke.py, through the kernels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zig_weekend_raytracer_tpu as zj
import zig_weekend_raytracer_tpu_torch as zt
from zig_weekend_raytracer_tpu.ops import pallas_bounce
from zig_weekend_raytracer_tpu.render import camera as jcam
from zig_weekend_raytracer_tpu.render import renderer as jr
from zig_weekend_raytracer_tpu.sampling.sampler import SamplerKind as JKind
from zig_weekend_raytracer_tpu_torch.ops import fused_render
from zig_weekend_raytracer_tpu_torch.render import camera as tcam
from zig_weekend_raytracer_tpu_torch.render import integrator
from zig_weekend_raytracer_tpu_torch.scene import (
    ARRAY_FIELDS,
    STATIC_FIELDS,
    TREE_FIELDS,
    TREE_STATIC_FIELDS,
    compiled_from_arrays,
)

RTOL, ATOL = 1e-5, 1e-6
W = H = 12
SPP, DEPTH = 2, 3


def _lanes():
    """px, py, s0, s1 and stride of JAX's _render_band_regen layout (one
    band, padded with dead lanes to the scene's block)."""
    s_par, band_rows = zj.render.Renderer().regen_geometry(W, H, SPP)
    tile = jr.pick_tile(W, band_rows)
    px, py, sidx, _ = (np.asarray(a) for a in jr.ray_grid(W, H, 0, band_rows, 0, s_par, tile))
    n = px.shape[0]
    n_pad = -(-n // 1024) * 1024
    pad = lambda a: np.concatenate([a, np.zeros(n_pad - n, np.int32)]).astype(np.int32)
    return pad(px), pad(py), pad(sidx), pad(np.full(n, SPP)), s_par


def _render_port(scene, lanes):
    px, py, s0, s1, stride = lanes
    calls = integrator.render_fused_reference.calls
    rad, work = fused_render.render_fused(
        scene.compiled, *(torch.from_numpy(a) for a in (px, py, s0, s1)), 0,
        zt.dtypes.T_MIN, camera_consts=tcam.camera_consts(scene.camera, W, H),
        sampler=zt.sampling.SamplerKind.SOBOL, width=W, height=H, spp=SPP,
        stride=stride, max_depth=DEPTH, has_dof=True, want_work=True,
    )
    assert integrator.render_fused_reference.calls == calls + 1
    return rad.to_array().numpy(), work.numpy()


@pytest.fixture(scope="module")
def balls():
    return zt.models.load_scene("balls", device="cpu")


@pytest.mark.parametrize("span", ["4", "2"])
def test_render_fused_matches_jax_kernel(pallas_interpret, monkeypatch, span):
    monkeypatch.setenv("ZWRT_LEAF_GROUPS", span)
    sj, st = zj.models.load_scene("balls"), zt.models.load_scene("balls", device="cpu")
    assert st.camera.has_depth_of_field and st.compiled.needs_gauss
    assert st.compiled.sph_leaf_span == int(span) and st.compiled.sph_tree_box.shape[0] > 1
    assert not st.compiled.light_params
    lanes = _lanes()
    px, py, s0, s1, stride = lanes
    rad_j, work_j = pallas_bounce.render_fused(
        sj.compiled, *(jnp.asarray(a) for a in (px, py, s0, s1)), jnp.uint32(0),
        np.float32(1e-3), camera_consts=jcam.camera_consts(sj.camera, W, H),
        sampler=JKind.SOBOL, width=W, height=H, spp=SPP, stride=stride,
        max_depth=DEPTH, has_dof=True, want_work=True,
    )
    rt, wt = _render_port(st, lanes)
    assert np.isfinite(rt).all()
    np.testing.assert_array_equal(wt, np.asarray(work_j))
    np.testing.assert_allclose(rt, np.stack([np.asarray(c) for c in rad_j], 1), rtol=RTOL, atol=ATOL)


def test_render_fused_single_leaf_equals_deep_tree(monkeypatch):
    """The JAX package's span makes balls one leaf, the port's default one
    group per leaf (a 121-node tree); both renders equal the span-4 render
    (a 31-node tree), which the test above holds to JAX."""
    monkeypatch.setenv("ZWRT_LEAF_GROUPS", "64")
    one_leaf = zt.models.load_scene("balls", device="cpu")
    assert one_leaf.compiled.sph_tree_box.shape[0] == 1
    monkeypatch.delenv("ZWRT_LEAF_GROUPS", raising=False)
    default = zt.models.load_scene("balls", device="cpu")
    assert default.compiled.sph_leaf_span == 1
    assert default.compiled.sph_tree_box.shape[0] == 121
    monkeypatch.setenv("ZWRT_LEAF_GROUPS", "4")
    deep = zt.models.load_scene("balls", device="cpu")
    lanes = _lanes()
    r4, w4 = _render_port(deep, lanes)
    for scene in (one_leaf, default):
        r, w = _render_port(scene, lanes)
        np.testing.assert_array_equal(w, w4)
        np.testing.assert_array_equal(r, r4)


def test_renderer_coherent_plan_matches_jax(pallas_interpret, balls):
    rj = zj.render.Renderer(samples_per_pixel=SPP, max_ray_bounce_depth=DEPTH, regen_min_wave=1)
    rt = zt.render.Renderer(samples_per_pixel=SPP, max_ray_bounce_depth=DEPTH, regen_min_wave=1)
    assert rt.regen_geometry(W, H, SPP)[0] == 1
    sj = zj.models.load_scene("balls")
    fb_j = np.asarray(rj.render(sj, W, H))
    calls = integrator.render_fused_reference.calls
    fb_t = rt.render(balls, W, H)
    assert integrator.render_fused_reference.calls == calls + 1
    (key_j, entry_j), = rj._plan_cache[sj.compiled].items()
    (key_t, entry_t), = rt._plan_cache[balls.compiled].items()
    assert key_j[0] == key_t[0] == "coh"
    n = W * H
    for a_j, a_t in zip(entry_j["plan"][:2], entry_t["plan"][:2]):
        np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j)[:n])
    assert fb_t.shape == (H, W, 3) and np.isfinite(fb_t).all()
    np.testing.assert_allclose(fb_t, fb_j, rtol=RTOL, atol=ATOL)


def test_first_hit_probe_keys(balls):
    """The probe traces sample 0 of every pixel; misses (sky) report -1."""
    from zig_weekend_raytracer_tpu_torch.render.renderer import _first_hit_probe

    ys, xs = np.divmod(np.arange(W * H), W)
    kind, idx = _first_hit_probe(
        balls, 0, torch.from_numpy(xs), torch.from_numpy(ys), width=W, height=H,
        spp=SPP, sampler=zt.sampling.SamplerKind.SOBOL, has_dof=True,
        cam_consts=tcam.camera_consts(balls.camera, W, H),
    )
    kind, idx = kind.numpy(), idx.numpy()
    assert set(np.unique(kind)) <= {-1, 0} and (kind == 0).any() and (kind == -1).any()
    assert (idx[kind == 0] < balls.compiled.n_spheres).all()


def test_carried_scene_renders_as_compiled(balls):
    sj = zj.models.load_scene("balls")
    cs = sj.compiled
    fields = {f: np.asarray(getattr(cs, f)) for f in ARRAY_FIELDS}
    fields.update({
        f: tuple(np.asarray(a) for a in getattr(cs, f)) if f.endswith("attrs")
        else np.asarray(getattr(cs, f)) for f in TREE_FIELDS
    })
    static = {f: getattr(cs, f) for f in STATIC_FIELDS + TREE_STATIC_FIELDS + ("has_bvh",)}
    carried = zt.scene.Scene(compiled_from_arrays(fields, static, "cpu"), balls.camera,
                             balls.background, "balls")
    lanes = _lanes()
    r_c, w_c = _render_port(carried, lanes)
    r_p, w_p = _render_port(balls, lanes)
    np.testing.assert_array_equal(w_c, w_p)
    np.testing.assert_array_equal(r_c, r_p)
