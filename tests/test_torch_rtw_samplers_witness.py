"""Witness for the pixels where the port's renders differ from the jitted
JAX renders: rtw_final under the stratified and independent samplers at
16x16, 4 spp, depth 4 (no other test pins the non-Sobol samplers on
rtw_final), and the pixels that tests/test_torch_tool_scenebench.py exempts
at 8x8, 4 spp, depth 4 under Sobol on rtw_final and balls.

For each case:
  1. the port's ``Renderer.render`` differs from JAX's (its XLA path on the
     CPU, jitted) within rtol 1e-5 / atol 1e-6 on exactly the named pixels;
  2. on every lane of those pixels (every sample), starting from the
     port's camera rays, the port's bounce chain (``integrator.bounce``)
     equals JAX's ``trace_paths`` run under ``jax.disable_jit`` (no fusion,
     so no contracted multiply-adds) within rtol 1e-6, as
     tests/test_torch_images.py::test_render_matches_eager_jax_chain holds
     the Sobol case; one named lane (ROUNDED_LANES) reads 3.3e-06 relative,
     an ulp-level rounding of torch's and XLA's CPU math over four bounces,
     and is held to that test's rtol 1e-5 / atol 1e-6.  The jitted JAX
     render contracts a light PDF or a hit into fused multiply-adds and
     moves these pixels by 0.1-0.8; the port rounds each product, as the
     eager JAX chain does.

The eager interpreter walks rtw_final's tree slowly, so all rtw_final lanes
of the three cases run in one eager call (the bounce draws hash the ray id
alone; the sampler only places the camera rays, which are given).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_reference_native import reference_decodes_with_stb  # noqa: F401
import zig_weekend_raytracer_tpu as zj
import zig_weekend_raytracer_tpu_torch as zt
from zig_weekend_raytracer_tpu.math.v3 import V3 as JV3
from zig_weekend_raytracer_tpu.ops.trace import _use_pallas_backend
from zig_weekend_raytracer_tpu.render.integrator import trace_paths as j_trace_paths
from zig_weekend_raytracer_tpu.sampling.sampler import SamplerKind as JKind
from zig_weekend_raytracer_tpu_torch.math.v3 import V3
from zig_weekend_raytracer_tpu_torch.render import camera as tcam
from zig_weekend_raytracer_tpu_torch.render import integrator

RTOL, ATOL = 1e-5, 1e-6
EAGER_RTOL = 1e-6
SPP, DEPTH = 4, 4
# (scene, sampler, size) -> the (x, y) pixels where the port's render and
# the jitted JAX render differ
CASES = {
    ("rtw_final", "STRATIFIED", 16): (
        (10, 4), (8, 5), (9, 5), (10, 5), (8, 6), (9, 6), (11, 6), (9, 7), (10, 7),
        (11, 7), (5, 8), (10, 8), (1, 10), (11, 11), (14, 12)),
    ("rtw_final", "INDEPENDENT", 16): (
        (8, 5), (9, 5), (10, 5), (11, 5), (5, 6), (8, 6), (9, 6), (10, 6), (11, 6),
        (12, 6), (7, 7), (8, 7), (11, 7), (9, 8), (10, 8), (14, 11), (14, 12)),
    # test_torch_tool_scenebench.py's RTW_PIXELS and BALLS_PIXELS
    ("rtw_final", "SOBOL", 8): ((4, 2), (3, 3), (4, 3), (6, 5), (7, 5), (0, 6)),
    ("balls", "SOBOL", 8): ((2, 3),),
}
# (x, y, sample) lanes held to rtol 1e-5 / atol 1e-6 against the eager chain
ROUNDED_LANES = {("rtw_final", "INDEPENDENT", 16): ((10, 5, 2),)}


@pytest.fixture(scope="module")
def scenes():
    return {name: (zj.models.load_scene(name), zt.models.load_scene(name, device="cpu"))
            for name in ("rtw_final", "balls")}


def _lanes(st, sampler, w, pixels):
    """The port's camera rays and bounce-chain radiance of every sample of
    ``pixels``: (o, d, tm, rid, radiance (N, 3))."""
    x, y, s = (torch.tensor(c) for c in zip(*[(px, py, k) for px, py in pixels
                                              for k in range(SPP)]))
    rid = (s * w + y) * w + x
    o, d, tm = tcam.generate_rays(
        tcam.camera_params_from_consts(tcam.camera_consts(st.camera, w, w)),
        st.camera.has_depth_of_field, getattr(zt.sampling.SamplerKind, sampler), 0, rid, x, y,
        s, SPP, w, w)
    n = rid.shape[0]
    thr, rad = V3.full((n,), 1.0, 1.0, 1.0, "cpu"), V3.zeros((n,), "cpu")
    oo, dd, alive = o, d, torch.ones(n, dtype=torch.bool)
    for k in range(DEPTH):
        oo, dd, thr, rad, alive = integrator.bounce(
            st.compiled, 0, zt.dtypes.T_MIN, torch.full((n,), k), oo, dd, tm, rid, thr, rad,
            alive)
    return o, d, tm, rid, rad.to_array().numpy()


def _eager(sj, o, d, tm, rid):
    """JAX's XLA ``trace_paths`` under ``jax.disable_jit`` on these rays."""
    j = lambda v: JV3(*(jnp.asarray(c.numpy()) for c in v))
    os.environ["ZWRT_NO_PALLAS"] = "1"
    _use_pallas_backend.cache_clear()
    try:
        with jax.disable_jit():
            out = j_trace_paths(sj.compiled, j(o), j(d), jnp.asarray(tm.numpy()), jnp.uint32(0),
                                jnp.asarray(rid.numpy().astype(np.uint32)), DEPTH)
    finally:
        del os.environ["ZWRT_NO_PALLAS"]
        _use_pallas_backend.cache_clear()
    return np.stack([np.asarray(c) for c in out], -1)


@pytest.fixture(scope="module")
def chains(scenes):
    """Every case's port lanes, and JAX's eager chain on them: one eager
    call per scene over the concatenated lanes."""
    out = {}
    for name in ("rtw_final", "balls"):
        sj, st = scenes[name]
        keys = [k for k in CASES if k[0] == name]
        lanes = {k: _lanes(st, k[1], k[2], CASES[k]) for k in keys}
        cat = [torch.cat([lanes[k][i] for k in keys]) if i in (2, 3) else
               V3(*(torch.cat([getattr(lanes[k][i], c) for k in keys]) for c in "xyz"))
               for i in range(4)]
        want = _eager(sj, *cat)
        at = 0
        for k in keys:
            n = lanes[k][4].shape[0]
            out[k] = (lanes[k][4], want[at:at + n])
            at += n
    return out


@pytest.mark.parametrize("case", list(CASES), ids=lambda c: f"{c[0]}-{c[1].lower()}-{c[2]}")
def test_jit_differences_are_contraction_witnesses(scenes, chains, case):
    name, sampler, w = case
    sj, st = scenes[name]
    fb_t = zt.render.Renderer(samples_per_pixel=SPP, max_ray_bounce_depth=DEPTH,
                              sampler=getattr(zt.sampling.SamplerKind, sampler)).render(st, w, w)
    fb_j = np.asarray(zj.render.Renderer(samples_per_pixel=SPP, max_ray_bounce_depth=DEPTH,
                                         sampler=getattr(JKind, sampler)).render(sj, w, w))
    assert np.isfinite(fb_t).all() and fb_t.mean() > 0
    differ = ~np.isclose(fb_t, fb_j, rtol=RTOL, atol=ATOL).all(-1)
    assert sorted((int(x), int(y)) for y, x in zip(*np.nonzero(differ))) == sorted(CASES[case])
    got, want = chains[case]
    lanes = [(x, y, k) for x, y in CASES[case] for k in range(SPP)]
    rounded = np.isin(np.arange(len(lanes)),
                      [lanes.index(lane) for lane in ROUNDED_LANES.get(case, ())])
    np.testing.assert_allclose(got[~rounded], want[~rounded], rtol=EAGER_RTOL, atol=0)
    np.testing.assert_allclose(got[rounded], want[rounded], rtol=RTOL, atol=ATOL)
