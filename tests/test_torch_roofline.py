"""The work counts behind the kernels' roofline bounds (utils/workcount.py,
utils/roofline.py): off by default, and when on, consistent with what the
plain versions did on the CPU.

  1. A cornell render (brute trace, a sphere and a quad light): camera rays
     equal to lanes x spp, bounces equal to the work the render returns,
     one trace per bounce with every primitive tested, hits by material
     adding up to the bounces that hit.
  2. The tree walk on rtw_final's camera rays: slab tests, leaf visits and
     leaf-slot tests by kind, each slot test a whole leaf's 8 x span slots;
     a masked launch's traces and bytes by live and dead rays.
  3. The bound: operations from the per-unit table, bytes, and which of
     the two bounds it; each operation class at its own rate.
  4. A texture-LUT render: the fetch's operations and the LUT's bytes; the
     unified tree's tables, which the uni walk reads instead of the
     per-kind trees.
  5. The per-unit table against its earlier FP32 counts, and the Sobol
     sampler's integer work in its two forms.
  6. The coherent plan's key launch: the probe's closest hits and each
     pixel's camera ray by sampler, with and without depth of field.
"""

import numpy as np
import pytest
import torch

import zig_weekend_raytracer_tpu_torch as zt
from test_torch_reference_native import reference_decodes_with_stb  # noqa: F401
from zig_weekend_raytracer_tpu_torch.ops import trace as ttrace
from zig_weekend_raytracer_tpu_torch.render import camera as tcam
from zig_weekend_raytracer_tpu_torch.render import integrator
from zig_weekend_raytracer_tpu_torch.sampling.sampler import SamplerKind, sobol_log2_scale
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
    per_bounce = roofline.total(ops) / c["bounce"]
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
    assert (roofline.total(roofline.trace_ops(c))
            > c["slab_test"] * roofline.total(roofline.OPS["slab_test"]))


def test_masked_hit_bytes_count_dead_rays_apart():
    """A masked closest-hit launch: the plain walk counts the live rays'
    traces, and the bytes are every ray's mask and hit plus a live ray's
    origin, direction and time; a dead ray reads nothing else."""
    sc = zt.models.load_scene("rtw_final", device="cpu")
    cs = sc.compiled
    w = 16
    ys, xs = torch.meshgrid(torch.arange(w), torch.arange(w), indexing="ij")
    px, py = xs.reshape(-1), ys.reshape(-1)
    o, d, tm = tcam.generate_rays(
        tcam.camera_params_from_consts(tcam.camera_consts(sc.camera, w, w)), False,
        zt.sampling.SamplerKind.SOBOL, 0, py * w + px, px, py, torch.zeros_like(px), 1, w, w)
    active = torch.from_numpy(np.random.default_rng(3).random(w * w) < 0.3)
    with workcount.counting() as c:
        ttrace.closest_hit(cs, o, d, tm, zt.dtypes.T_MIN, active=active)
    live = int(active.sum())
    assert c["trace"] == live < w * w
    tables = roofline.trace_bytes(cs)
    assert roofline.hit_bytes(cs, w * w, live) == w * w * 13 + live * 28 + tables
    assert roofline.hit_bytes(cs, w * w, w * w) == roofline.hit_bytes(cs, w * w) + w * w
    assert roofline.hit_bytes(cs, w * w, 0) == w * w * 13 + tables
    ms, _ = roofline.hit_bound_ms(c, cs, w * w, live=live)
    assert ms == pytest.approx(roofline.bound_ms(
        roofline.trace_ops(c), roofline.hit_bytes(cs, w * w, live))[0])


def test_uni_walk_reads_the_unified_tree(monkeypatch):
    """Under the uni walk a trace reads the unified tree alone: its nodes
    packed in 32 bytes each and its leaf slots with their original
    indices (spheres 8 + 1 words, quads 16 + 1)."""
    monkeypatch.setenv("ZWRT_UNI_TREE", "1")
    cs = zt.models.load_scene("rtw_final", device="cpu").compiled
    want = (cs.uni_tree_box.shape[0] * 32 + cs.uni_sph_attrs[-1].numel() * 9 * 4
            + cs.uni_quad_attrs[-1].numel() * 17 * 4)
    assert roofline.trace_bytes(cs, "uni") == want
    for walk in (None, "cond", "queue", "spec"):
        assert roofline.trace_bytes(cs, walk) == roofline.trace_bytes(cs)
    assert (roofline.render_table_bytes(cs, 1, "uni") - roofline.render_table_bytes(cs, 1)
            == want - roofline.trace_bytes(cs))


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
    fetch = roofline.OPS["texel_quad"]
    assert fetch["fp"] + fetch["cmp"] == 44
    assert roofline.total(ops) - roofline.total(roofline.render_ops(no_texel, cs, has_dof=False)) \
        == roofline.total(fetch) * c["texel_quad"]
    ms, by = roofline.bound_ms(ops, w * w * 32 + roofline.render_table_bytes(cs))
    assert by == "bytes" and np.isclose(ms, (w * w * 32 + roofline.render_table_bytes(cs))
                                        / roofline.PEAK_BYTES * 1e3)


def test_bound_prices_each_class_at_its_rate():
    """Every operation passes the one dispatch slot at the fp rate, and
    each class its own pipe: compares at half the rate bound a
    compare-heavy count, the dispatch slot a mixed one."""
    rates = {"fp": 32e12, "cmp": 16e12, "int": 8e12}
    ms, by = roofline.bound_ms({"fp": 0, "cmp": 16e12, "int": 0}, 1.0, rates)
    assert by == "operations" and np.isclose(ms, 1e3)
    ms, _ = roofline.bound_ms({"fp": 16e12, "cmp": 8e12, "int": 8e12}, 1.0, rates)
    assert np.isclose(ms, 1e3)  # the int pipe: 8e12 / 8e12
    ms, _ = roofline.bound_ms({"fp": 24e12, "cmp": 4e12, "int": 4e12}, 1.0, rates)
    assert np.isclose(ms, 1e3)  # the dispatch slot: 32e12 / 32e12
    # one number is the fp rate, the others at the data sheet's ratio
    assert np.isclose(roofline.ops_seconds({"fp": 0, "cmp": 1e12, "int": 0}, 32e12), 1 / 16)
    assert roofline.DATA_SHEET_RATES["cmp"] == roofline.PEAK_FP32_OPS / 2


# The per-unit FP32 counts before the classes (compares and selects
# counted as FP32)
PR5_FP32 = {
    "camera_ray": 30, "camera_dof": 31, "trace": 9, "sphere_test": 28, "quad_test": 39,
    "leaf_visit": 16, "shade": 16, "hit_sphere": 12, "checker": 6, "miss": 6,
    "hit_emissive": 6, "hit_lambertian": 87, "hit_isotropic": 55, "hit_metal": 24,
    "hit_metal_gauss": 60, "hit_dielectric": 68, "texel_sphere": 26, "texel_quad": 44,
    "light_pdf_sphere": 52, "light_pdf_quad": 73, "light_sample_sphere": 77,
    "light_sample_quad": 15,
}


@pytest.mark.parametrize("unit", sorted(PR5_FP32))
def test_ops_split_keeps_the_fp32_counts(unit):
    """Each unit's fp and cmp classes add up to the earlier FP32 count;
    only the slab test grew, its 12 NaN-propagating min/max now a compare
    and a select each."""
    ops = roofline.OPS[unit]
    assert ops["fp"] + ops["cmp"] == PR5_FP32[unit] and ops["int"] >= 0


def test_slab_and_sobol_integer_counts():
    slab = roofline.OPS["slab_test"]
    assert slab["fp"] == 13 and slab["cmp"] == 2 * 12 + 1
    # a pixel's part by the bit loops: 28 VdC columns, 2L inverse columns,
    # 2 x 52 generator columns
    pixel = roofline.sobol_pixel_ops(9)
    assert pixel == {"fp": 0, "cmp": 0, "int": 3 * 28 + 6 * 18 + 8 * 52}
    assert roofline.sobol_pixel_ops(0)["int"] == 8 * 52
    # a sample in the factored form: three per byte and dimension, two XORs
    # with the pixel's part
    table = roofline.sobol_ops(2)
    assert table == {"fp": 0, "cmp": 0, "int": 14} and 14 < pixel["int"] / 40
    pcg = roofline.OPS["shade"]["int"]
    assert pcg >= 20  # one PCG4D draw per bounce
    counts = {"camera_ray": 10, "bounce": 0}
    sc = zt.models.load_scene("cornell_box", device="cpu")
    with_sobol = roofline.render_ops(counts, sc.compiled, False, sobol=2)
    plain = roofline.render_ops(counts, sc.compiled, False)
    assert with_sobol["int"] - plain["int"] == 10 * table["int"]


@pytest.mark.parametrize("has_dof", [False, True])
@pytest.mark.parametrize("sampler", list(SamplerKind))
def test_keys_bound_counts_the_camera_ray_and_the_probe(sampler, has_dof):
    """6. coherent_keys_kernel's bound: the plain probe's closest hits (one
    trace a pixel) and, per pixel, the camera ray of the sampler, the lens
    with depth of field, and the key; Sobol adds its bit loops once for
    the pixel part and its tables for sample 0."""
    from zig_weekend_raytracer_tpu_torch.render import renderer as rmod

    scene = zt.models.load_scene("balls", device="cpu")
    w = h = 16
    pix = torch.arange(w * h)
    with workcount.counting() as counts:
        rmod._first_hit_probe(scene, 3, pix % w, pix // w, width=w, height=h, spp=8,
                              sampler=sampler, has_dof=has_dof,
                              cam_consts=tcam.camera_consts(scene.camera, w, h))
    assert counts["trace"] == w * h and counts["slab_test"] > 0
    pixel = roofline.keys_pixel_ops(sampler, has_dof, w, h)
    lens = roofline.KEYS_OPS["dof"] if has_dof else roofline._ops()
    bits = roofline._ops()
    if sampler == SamplerKind.SOBOL:
        log2_scale = sobol_log2_scale(w, h)
        bits = roofline.add(roofline.sobol_pixel_ops(log2_scale), roofline.sobol_ops(1))
    assert pixel == roofline.add(roofline.KEYS_OPS["common"], roofline.KEYS_OPS[sampler],
                                 lens, bits)
    # each sampler draws its offset: a PCG4D at least, or the Sobol bits
    assert pixel["int"] >= roofline.KEYS_OPS["common"]["int"] + 20
    ops = roofline.add(roofline.times(pixel, w * h), roofline.trace_ops(counts))
    sobol_bytes = 5 * 52 * 4 + 2 * 256 * 4 if sampler == SamplerKind.SOBOL else 0
    nbytes = roofline.trace_bytes(scene.compiled) + sobol_bytes + w * h * 8
    ms, by = roofline.keys_bound_ms(counts, scene.compiled, w * h, sampler, has_dof, w, h)
    assert (ms, by) == roofline.bound_ms(ops, nbytes) and ms > 0
