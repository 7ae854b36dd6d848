"""Witness for the pixels where the port's renders of the nested-checker
scenes differ from the jitted JAX renders: test_torch_fixed_depth.py's
``_nested`` scenes (the nested quad; with an image child; with the image
child and a 48-texel LUT, which this path does not read) at 16x16, 4 spp,
depth 4, under each sampler.

For each case:
  1. the port's ``Renderer.render`` (the fixed-depth path) differs from
     JAX's (its XLA path on the CPU, jitted) within rtol 1e-5 / atol 1e-6
     on exactly the named pixels (CASES): each is about one sample's
     checker flip, where XLA's contracted multiply-adds put a hit point on
     the other side of a lattice plane than the port's rounded products;
  2. the port equals JAX's render run under ``jax.disable_jit`` (no
     fusion, so no contracted multiply-adds) within rtol 1e-6 on every
     pixel, the named ones included, but for JIT_PIXELS: there the port
     equals the jitted render within rtol 1e-6 and the eager render
     differs from both by more than rtol 1e-5 / atol 1e-6, so the
     reference disagrees with itself at that pixel.
"""

import os

import jax
import numpy as np
import pytest

import zig_weekend_raytracer_tpu as zj
import zig_weekend_raytracer_tpu_torch as zt
from test_torch_fixed_depth import LUT, _nested
from test_torch_reference_native import reference_decodes_with_stb  # noqa: F401
from zig_weekend_raytracer_tpu.ops.trace import _use_pallas_backend

W = H = 16
SPP, DEPTH = 4, 4
RTOL, ATOL = 1e-5, 1e-6
EAGER_RTOL = 1e-6
SCENES = {"nested": {}, "nested_image": {"image": True},
          "nested_lut": {"image": True, "lut": LUT}}
SAMPLERS = ("SOBOL", "STRATIFIED", "INDEPENDENT")
_PLAIN = {"SOBOL": ((1, 7), (7, 2)), "STRATIFIED": ((5, 11), (5, 12)),
          "INDEPENDENT": ((6, 8), (6, 10))}
_IMAGE = {**_PLAIN, "STRATIFIED": ((5, 11), (5, 12), (6, 10))}
# (scene, sampler) -> the (x, y) pixels where the port's render and the
# jitted JAX render differ
CASES = {(name, sampler): (_PLAIN if name == "nested" else _IMAGE)[sampler]
         for name in SCENES for sampler in SAMPLERS}
# (scene, sampler) -> the pixels where the port equals the jitted render
# and JAX's eager render differs from it
JIT_PIXELS = {("nested_image", "STRATIFIED"): ((7, 9),),
              ("nested_lut", "STRATIFIED"): ((7, 9),)}


def _mask(pixels):
    m = np.zeros((H, W), bool)
    for x, y in pixels:
        m[y, x] = True
    return m


def _pixels(mask):
    return sorted((int(x), int(y)) for y, x in zip(*np.nonzero(mask)))


@pytest.fixture(scope="module")
def renders():
    """Every case's renders: the port's, JAX's jitted and JAX's eager."""
    out = {}
    for name, kw in SCENES.items():
        sj, st = _nested(zj, **kw), _nested(zt, **kw)
        for sampler in SAMPLERS:
            jr = zj.render.Renderer(samples_per_pixel=SPP, max_ray_bounce_depth=DEPTH,
                                    sampler=getattr(zj.sampling.SamplerKind, sampler))
            fb_t = zt.render.Renderer(samples_per_pixel=SPP, max_ray_bounce_depth=DEPTH,
                                      sampler=getattr(zt.sampling.SamplerKind, sampler)
                                      ).render(st, W, H)
            fb_j = np.asarray(jr.render(sj, W, H))
            os.environ["ZWRT_NO_PALLAS"] = "1"
            _use_pallas_backend.cache_clear()
            try:
                with jax.disable_jit():
                    fb_e = np.asarray(jr.render(sj, W, H))
            finally:
                del os.environ["ZWRT_NO_PALLAS"]
                _use_pallas_backend.cache_clear()
            out[(name, sampler)] = (fb_t, fb_j, fb_e)
    return out


@pytest.mark.parametrize("case", list(CASES), ids=lambda c: f"{c[0]}-{c[1].lower()}")
def test_jit_differences_are_contraction_witnesses(renders, case):
    fb_t, fb_j, fb_e = renders[case]
    assert fb_t.shape == (H, W, 3) and np.isfinite(fb_t).all() and fb_t.max() > 0
    differ = ~np.isclose(fb_t, fb_j, rtol=RTOL, atol=ATOL).all(-1)
    assert _pixels(differ) == sorted(CASES[case])
    jit = _mask(JIT_PIXELS.get(case, ()))
    np.testing.assert_allclose(fb_t[~jit], fb_e[~jit], rtol=EAGER_RTOL, atol=0)
    np.testing.assert_allclose(fb_t[jit], fb_j[jit], rtol=EAGER_RTOL, atol=0)
    eager_differ = ~np.isclose(fb_t, fb_e, rtol=RTOL, atol=ATOL).all(-1)
    assert _pixels(eager_differ) == sorted(JIT_PIXELS.get(case, ()))
