"""The work counts behind the kernels' roofline bounds (utils/workcount.py,
utils/roofline.py): off by default, and when on, consistent with what the
plain versions did on the CPU.

  1. A cornell render (brute trace, a sphere and a quad light): camera rays
     equal to lanes x spp, bounces equal to the work the render returns,
     one trace per bounce with every primitive tested, hits by material
     adding up to the bounces that hit.
  2. The tree walk on rtw_final's camera rays: slab tests, leaf visits and
     leaf-slot tests by kind, each slot test a whole leaf's 8 x span slots.
  3. The bound: operations from the per-unit table, bytes, and which of
     the two bounds it.
  4. A texture-LUT render: the fetch's operations and the LUT's bytes.
"""

import numpy as np
import pytest
import torch

import zig_weekend_raytracer_tpu_torch as zt
from zig_weekend_raytracer_tpu_torch.ops import trace as ttrace
from zig_weekend_raytracer_tpu_torch.render import camera as tcam
from zig_weekend_raytracer_tpu_torch.render import integrator
from zig_weekend_raytracer_tpu_torch.utils import roofline, workcount


def _lanes(w):
    ys, xs = torch.meshgrid(torch.arange(w), torch.arange(w), indexing="ij")
    px = xs.reshape(-1).to(torch.int32)
    return px, ys.reshape(-1).to(torch.int32), torch.zeros_like(px)


def test_counts_off_by_default():
    assert not workcount.enabled()
    workcount.add("bounce", 5)  # a no-op when off
    with workcount.counting() as c:
        assert workcount.enabled()
        workcount.add("bounce", torch.tensor(3))
    assert dict(c) == {"bounce": 3} and not workcount.enabled()


def test_render_counts_match_the_render():
    sc = zt.models.load_scene("cornell_box", device="cpu")
    cs = sc.compiled
    w, spp, depth = 8, 4, 5
    px, py, s0 = _lanes(w)
    kw = dict(camera_consts=tcam.camera_consts(sc.camera, w, w),
              sampler=zt.sampling.SamplerKind.SOBOL, width=w, height=w, spp=spp, stride=1,
              max_depth=depth, has_dof=False)
    with workcount.counting() as c:
        _, work = integrator.render_fused_reference(
            cs, px, py, s0, s0 + spp, 0, zt.dtypes.T_MIN, want_work=True, **kw)
    assert c["camera_ray"] == w * w * spp
    assert c["bounce"] == c["trace"] == int(work.sum())
    assert c["sphere_test"] == c["trace"] * cs.n_spheres
    assert c["quad_test"] == c["trace"] * cs.n_quads
    hits = c["bounce"] - c["miss"]
    assert sum(c[f"hit_{m}"] for _, m in integrator._MATERIALS) == hits > 0
    assert c["hit_sphere"] <= hits and c["slab_test"] == 0
    ops = roofline.render_ops(c, cs, has_dof=False)
    per_bounce = ops / c["bounce"]
    # at least the trace of every primitive, at most every unit at once
    assert cs.n_spheres * 28 + cs.n_quads * 39 < per_bounce < 2000


def test_tree_walk_counts():
    sc = zt.models.load_scene("rtw_final", device="cpu")
    cs = sc.compiled
    assert cs.has_sph_tree and cs.has_quad_tree
    w = 16
    ys, xs = torch.meshgrid(torch.arange(w), torch.arange(w), indexing="ij")
    px, py = xs.reshape(-1), ys.reshape(-1)
    o, d, tm = tcam.generate_rays(
        tcam.camera_params_from_consts(tcam.camera_consts(sc.camera, w, w)), False,
        zt.sampling.SamplerKind.SOBOL, 0, py * w + px, px, py, torch.zeros_like(px), 1, w, w)
    with workcount.counting() as c:
        ttrace.closest_hit(cs, o, d, tm, zt.dtypes.T_MIN)
    assert c["trace"] == w * w
    assert c["slab_test"] >= 2 * w * w  # at least each kind's root
    assert c["leaf_visit"] > 0
    spans = cs.sph_leaf_span * 8 + cs.quad_leaf_span * 8
    assert c["sphere_test"] % (cs.sph_leaf_span * 8) == 0
    assert c["quad_test"] % (cs.quad_leaf_span * 8) == 0
    assert c["sphere_test"] + c["quad_test"] <= c["leaf_visit"] * spans
    assert roofline.trace_ops(c) > c["slab_test"] * roofline.OPS["slab_test"]


@pytest.mark.parametrize("ops,nbytes,by", [(33.5e12, 1.0, "operations"), (1.0, 3.35e12, "bytes")])
def test_bound(ops, nbytes, by):
    """One second of the data sheet's lane-operation rate (67 TFLOP/s
    counts an FMA as two FLOPs, so 33.5e12 lane-operations) or of its
    bytes."""
    ms, got = roofline.bound_ms(ops, nbytes)
    assert got == by and np.isclose(ms, 1e3)
    assert roofline.PEAK_FP32_OPS == 67e12 / 2


def test_bound_with_a_measured_rate():
    """A rate measured by tools/fp32_peak.py replaces the data sheet's, and
    the bound says so."""
    ms, by = roofline.bound_ms(30e12, 1.0, ops_rate=30e12)
    assert by == "operations" and np.isclose(ms, 1e3)
    assert roofline.peak_source(30e12) == "fp32_peak"
    assert roofline.peak_source(None) == "data_sheet"


def test_table_bytes_count_the_atlas():
    sc = zt.models.load_scene("shrek_quads", device="cpu")
    cs = sc.compiled
    assert roofline.trace_bytes(cs) == cs.n_quads * 16 * 4
    assert roofline.render_table_bytes(cs) == (
        roofline.trace_bytes(cs) + cs.shade_rows.numel() * 4 + 5 * 52 * 4 + 292 * 300 * 4)


def test_lut_fetch_counts_and_bytes():
    """A texture-LUT render counts each texel fetch with the atlas fetch's
    operations (26 on a sphere, 44 on a quad) and its bound reads the LUT
    once in place of the atlas: shrek_quads' 300 x 292 image (w x h)
    box-downsampled to 75 x 73 texels at an 8192 budget, padded to 128."""
    sc = zt.models.load_scene("shrek_quads", device="cpu", texture_lut=8192)
    cs = sc.compiled
    assert cs.tex_lut_dims == ((75, 73, 0),) and cs.tex_lut_tab.numel() == 5504
    assert roofline.image_table_bytes(cs) == 5504 * 4
    assert roofline.render_table_bytes(cs) == (
        roofline.trace_bytes(cs) + cs.shade_rows.numel() * 4 + 5 * 52 * 4 + 5504 * 4)
    w, spp, depth = 8, 2, 3
    px, py, s0 = _lanes(w)
    kw = dict(camera_consts=tcam.camera_consts(sc.camera, w, w),
              sampler=zt.sampling.SamplerKind.SOBOL, width=w, height=w, spp=spp, stride=1,
              max_depth=depth, has_dof=False)
    with workcount.counting() as c:
        integrator.render_fused_reference(cs, px, py, s0, s0 + spp, 0, zt.dtypes.T_MIN, **kw)
    hits = c["bounce"] - c["miss"]
    assert c["texel_quad"] == hits > 0 and c.get("texel_sphere", 0) == 0
    no_texel = {k: v for k, v in c.items() if not k.startswith("texel_")}
    ops = roofline.render_ops(c, cs, has_dof=False)
    assert ops - roofline.render_ops(no_texel, cs, has_dof=False) == 44 * c["texel_quad"]
    ms, by = roofline.bound_ms(ops, w * w * 32 + roofline.render_table_bytes(cs))
    assert by == "bytes" and np.isclose(ms, (w * w * 32 + roofline.render_table_bytes(cs))
                                        / roofline.PEAK_BYTES * 1e3)
