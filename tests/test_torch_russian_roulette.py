"""Russian roulette in the PyTorch port on the CPU (``Renderer(
russian_roulette=N)``, ``--russian_roulette``), against the JAX package.

From bounce ``rr_start`` on a live path continues with p = clamp(max(its
incoming throughput), RR_P_MIN, 1) against the site-3 draw, and its
throughput carries 1 / p.  The port's plain versions follow the JAX kernels
and their gate (``pallas_bounce.py:_base_cfg``): off on an image scene
without a texture LUT, on with one.

  1. The whole-render kernel's plain version against JAX's ``render_fused``
     (Pallas interpret) at cornell 16x16, 2 spp, depth 3, RR from bounce
     1: work counts bitwise, radiance within rtol 1e-6 / atol 1e-7, on
     every lane but test_torch_fused_render's EDGE_LANES (the floor/wall
     edge rays its witness test settles: XLA's contracted multiply-adds
     miss where the port's unfused ones hit).
  2. The bounce kernel's one-bounce plain version against JAX's
     ``bounce_pallas`` on seeded cornell rays at bounces 1 and 2: alive
     bitwise, radiance within rtol 1e-6 / atol 1e-7, and each bitwise RR's
     formula applied to its own bounce without RR.
  3. RR changes the sample set; the RR render's mean is the plain render's
     within 2% at 256 spp (JAX's test_rr_unbiased_mean).
  4. The gate: an atlas image scene renders bitwise as with RR off; with
     a texture LUT RR applies, and the plain render equals JAX's kernel.

The CUDA kernels' estimator instantiations are held against these plain
versions on the card by chip_smoke.py (phase 23).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zig_weekend_raytracer_tpu as zj
import zig_weekend_raytracer_tpu_torch as zt
from test_torch_fused_render import EDGE_LANES, _jax_regen_lanes
from test_torch_reference_native import reference_decodes_with_stb  # noqa: F401
from zig_weekend_raytracer_tpu.math.v3 import V3 as JV3
from zig_weekend_raytracer_tpu.ops import pallas_bounce
from zig_weekend_raytracer_tpu.render import camera as jcam
from zig_weekend_raytracer_tpu.sampling.sampler import SamplerKind as JKind
from zig_weekend_raytracer_tpu_torch.math.v3 import V3
from zig_weekend_raytracer_tpu_torch.ops import bounce as tbounce
from zig_weekend_raytracer_tpu_torch.ops import fused_render
from zig_weekend_raytracer_tpu_torch.render import camera as tcam
from zig_weekend_raytracer_tpu_torch.render import integrator

RTOL, ATOL = 1e-6, 1e-7


@pytest.fixture(scope="module")
def cornell():
    return zj.models.load_scene("cornell_box"), zt.models.load_scene("cornell_box", device="cpu")


def render_pair(sj, st, width, height, spp, depth, edge_lanes=(), **opts):
    """The port's plain render_fused and JAX's kernel on JAX's regen lane
    layout with the estimator options ``opts``; asserts work bitwise and
    radiance within RTOL / ATOL off ``edge_lanes``; returns the port's
    (radiance (N, 3), work)."""
    px, py, s0, s1, stride = _jax_regen_lanes(sj, width, height, spp)
    rad_j, work_j = pallas_bounce.render_fused(
        sj.compiled, *(jnp.asarray(a) for a in (px, py, s0, s1)), jnp.uint32(0),
        np.float32(1e-3), camera_consts=jcam.camera_consts(sj.camera, width, height),
        sampler=JKind.SOBOL, width=width, height=height, spp=spp, stride=stride,
        max_depth=depth, has_dof=sj.camera.has_depth_of_field, want_work=True, **opts,
    )
    rad_t, work_t = fused_render.render_fused(
        st.compiled, *(torch.from_numpy(a) for a in (px, py, s0, s1)), 0,
        zt.dtypes.T_MIN, camera_consts=tcam.camera_consts(st.camera, width, height),
        sampler=zt.sampling.SamplerKind.SOBOL, width=width, height=height, spp=spp,
        stride=stride, max_depth=depth, has_dof=st.camera.has_depth_of_field,
        want_work=True, **opts,
    )
    rj = np.stack([np.asarray(c) for c in rad_j], 1)
    rt = rad_t.to_array().numpy()
    edge = np.zeros(px.shape, bool)
    for x, y, s in edge_lanes:
        edge |= (px == x) & (py == y) & (s0 == s) & (s1 > s0)
    assert edge.sum() == len(edge_lanes)
    assert np.isfinite(rt).all()
    np.testing.assert_array_equal(work_t.numpy()[~edge], np.asarray(work_j)[~edge])
    np.testing.assert_allclose(rt[~edge], rj[~edge], rtol=RTOL, atol=ATOL)
    return rt, work_t.numpy()


def test_rr_render_matches_jax_kernel(pallas_interpret, cornell):
    rt, work = render_pair(*cornell, 16, 16, 2, 3, EDGE_LANES, rr_start=1)
    _, work0 = render_pair(*cornell, 16, 16, 2, 3, EDGE_LANES)
    # RR ended some paths early: fewer bounces in all
    assert work.sum() < work0.sum()


def cornell_rays(n=2048, seed=3):
    """Rays from around cornell's camera into the box, with throughput in
    [0.02, 1] (so that p spans RR_P_MIN to 1), radiance, ray ids and about
    90% of the lanes alive."""
    rng = np.random.default_rng(seed)
    o = np.asarray((278, 278, -800), np.float32) + rng.normal(0, 20, (n, 3)).astype(np.float32)
    d = (np.asarray((278, 278, 0), np.float32) + rng.uniform(-260, 260, (n, 3)) - o)
    f32 = lambda *s: rng.uniform(0.0, 1.0, s).astype(np.float32)
    return dict(
        origin=o.T.copy(), direction=d.astype(np.float32).T.copy(), time=f32(n),
        ray_id=rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32),
        throughput=0.02 + 0.98 * f32(3, n), radiance=0.5 * f32(3, n),
        alive=rng.uniform(size=n) < 0.9,
    )


def one_bounce_pair(sj, st, r, depth, **opts):
    """The port's plain one bounce (CPU tensors through ops/bounce.py) and
    JAX's bounce_pallas on rays ``r``: (port, jax), each (state rows (12,
    N), alive)."""
    v3 = lambda a: V3(*(torch.from_numpy(a[i]) for i in range(3)))
    got = tbounce.bounce(
        st.compiled, 0, zt.dtypes.T_MIN, depth, v3(r["origin"]), v3(r["direction"]),
        torch.from_numpy(r["time"]), torch.from_numpy(r["ray_id"].astype(np.int64)),
        v3(r["throughput"]), v3(r["radiance"]), torch.from_numpy(r["alive"]), **opts,
    )
    jv3 = lambda a: JV3(*(jnp.asarray(a[i]) for i in range(3)))
    want = pallas_bounce.bounce_pallas(
        sj.compiled, jv3(r["origin"]), jv3(r["direction"]), jnp.asarray(r["time"]),
        jnp.asarray(r["ray_id"]), jv3(r["throughput"]), jv3(r["radiance"]),
        jnp.asarray(r["alive"]), jnp.uint32(0), depth, np.float32(zt.dtypes.T_MIN), **opts,
    )[:5]

    def stack(state):
        arr = lambda v: np.stack([np.asarray(c) for c in v])
        o, d, thr, rad, alive = state
        return np.concatenate([arr(o), arr(d), arr(thr), arr(rad)]), np.asarray(alive)

    return stack(got), stack(want)


@pytest.mark.parametrize("depth", [1, 2])
def test_rr_one_bounce_matches_jax_kernel(pallas_interpret, cornell, depth):
    """RR at bounce ``depth``: the port's one bounce and JAX's kernel each
    equal RR's formula applied to their own bounce without RR, bitwise
    (the site-3 draw from JAX's hashrng), and agree on alive and radiance.
    Their throughputs are not compared here: XLA contracts the hit point's
    and the light pdf's multiply-adds on the CPU, which moves JAX's by
    ulps with RR or without."""
    from zig_weekend_raytracer_tpu.sampling import hashrng as jrng

    r = cornell_rays()
    (got0, alive0), (want0, _) = one_bounce_pair(*cornell, r, depth)
    (got, alive_t), (want, alive_j) = one_bounce_pair(*cornell, r, depth, rr_start=1)
    np.testing.assert_array_equal(alive_t, alive_j)
    np.testing.assert_allclose(got[9:], want[9:], rtol=RTOL, atol=ATOL)
    # the formula: p from the incoming throughput, the kill, the 1 / p weight
    site = np.uint32(8 + 4 * depth + 3)
    u = np.asarray(jrng.uniform1(jnp.uint32(0), jnp.asarray(r["ray_id"]), site))
    p = np.clip(r["throughput"].max(0), np.float32(0.05), np.float32(1.0))
    apply = r["alive"]
    np.testing.assert_array_equal(alive_t, alive0 & ~(apply & (u >= p)))
    weight = np.where(apply, np.float32(1.0) / p, np.float32(1.0)).astype(np.float32)
    for rr, base in ((got, got0), (want, want0)):
        np.testing.assert_array_equal(rr[6:9], base[6:9] * weight)
        np.testing.assert_array_equal(rr[:6], base[:6])
        np.testing.assert_array_equal(rr[9:], base[9:])
    assert (alive0 & ~alive_t).sum() > 10


def test_rr_changes_the_sample_set(cornell):
    _, st = cornell
    base = zt.render.Renderer(samples_per_pixel=8, max_ray_bounce_depth=8, seed=0)
    rr = zt.render.Renderer(samples_per_pixel=8, max_ray_bounce_depth=8, seed=0,
                            russian_roulette=1)
    fb0 = base.render(st, 16, 16)
    fb1 = rr.render(st, 16, 16)
    assert np.isfinite(fb1).all()
    assert np.abs(fb1 - fb0).max() > 1e-4


def test_rr_unbiased_mean(cornell):
    """JAX's 2% band at 256 spp on an 8x8 cornell: a missing 1 / p, a kill
    before the bounce's own radiance or a wrong clamp of p shift the mean
    by 10% or more."""
    _, st = cornell
    base = zt.render.Renderer(samples_per_pixel=256, max_ray_bounce_depth=6, seed=0)
    rr = zt.render.Renderer(samples_per_pixel=256, max_ray_bounce_depth=6, seed=0,
                            russian_roulette=2)
    m0 = float(base.render(st, 8, 8).mean())
    m1 = float(rr.render(st, 8, 8).mean())
    assert abs(m1 - m0) < 0.02 * m0, (m0, m1)


def test_rr_ignored_on_atlas_image_scenes():
    st = zt.models.load_scene("shrek_quads", device="cpu")
    base = zt.render.Renderer(samples_per_pixel=2, max_ray_bounce_depth=4, seed=0)
    rr = zt.render.Renderer(samples_per_pixel=2, max_ray_bounce_depth=4, seed=0,
                            russian_roulette=2)
    np.testing.assert_array_equal(base.render(st, 12, 12), rr.render(st, 12, 12))
    assert integrator.estimator_options(st.compiled, 2, 0.5) == (0, 0.0)


def test_rr_applied_with_a_texture_lut(pallas_interpret):
    """shrek_quads with a native-budget LUT takes the whole-render kernel,
    which applies RR (as JAX's does): it changes the image, and the plain
    render equals JAX's kernel at the same budget."""
    budget = 1 << 22
    os.environ["ZWRT_TEX_LUT"] = str(budget)
    try:
        sj = zj.models.load_scene("shrek_quads")
    finally:
        del os.environ["ZWRT_TEX_LUT"]
    st = zt.models.load_scene("shrek_quads", device="cpu", texture_lut=budget)
    assert integrator.estimator_options(st.compiled, 1, 0.0) == (1, 0.0)
    rt, work = render_pair(sj, st, 12, 12, 2, 3, rr_start=1)
    rt0, work0 = render_pair(sj, st, 12, 12, 2, 3)
    assert work.sum() < work0.sum() and np.abs(rt - rt0).max() > 1e-4
